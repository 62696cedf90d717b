"""Vectorized pending-queue scheduling pass — Algorithm 1 over flat arrays
(the port's copy of the reference's ``core/pass_batch.py``, numpy on the
host, same arithmetic).

``core.pair_batch`` vectorized Algorithm 2 for *one* pending job
against all donors; the pass around it was still a Python loop: sort the
pending queue, and per job re-derive donor state, call the decision
core, and walk the placement. At datacenter scale (10k GPUs, 100k jobs)
that per-job Python overhead dominates the schedule pass.

This module keeps the whole pass in preallocated NumPy arrays:

* :class:`FlatJobs` — per-job columns (progress, rate, blocked-until,
  memory footprint, solo iteration time, model code) mirrored from the
  engine's mutations, plus a swap-remove donor index fed by
  ``ClusterState._mark_single``/``_unmark_single``. Attached to the
  cluster as ``ClusterState._flat``; ``None`` means no mirror is kept
  (the scalar and batched paths).
* :class:`GridPass` — an append-only flat table over the pending queue
  (sort keys, GPU wants, padded Algorithm-2 candidate tables) and the
  pass driver: it evaluates Theorem 1 for all pending jobs x all donors
  x all candidate sub-batches in one (chunked) grid and walks placements
  with a masked ``(key, jid)`` argmin instead of a sorted Python loop.

The walk reproduces the scalar pass exactly: the scalar path visits
pending jobs once in ``(expected_remaining_time, jid)`` order, jobs it
cannot act on have no side effects, and a placement never makes it
*revisit* an earlier job within the same pass — so after each placement
the argmin continues from a ``(key, jid)`` floor. A job is actionable
when it fits the free GPUs outright, or when its sharing donors' single
GPUs plus the free GPUs cover the request (the exact success predicate
of the scalar placement loop; donor order only changes *which* GPUs).
The arithmetic reuses :func:`core.pair_batch._theorem1` and
``_structural_xi`` element-for-element, so grid decisions are bitwise
identical to the scalar/batched paths.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .interference import InterferenceModel
from .job import Job, JobState
from .pair_batch import _structural_xi, _theorem1, job_candidate_table

__all__ = ["FlatJobs", "GridPass"]

# max elements of a (pending-chunk x donor x candidate) grid temporary
_CHUNK_ELEMS = 2_000_000


class FlatJobs:
    """Flat per-job columns + donor index, mirrored from engine mutations.

    The engine pushes updates at every site that changes the mirrored
    fields (``_accrue``, ``start_job``, ``preempt_job``,
    ``reconfigure_job``, rate refreshes); ``ClusterState`` pushes donor
    membership/ownership counts from its single-occupancy index. Columns
    for jobs that never ran are unspecified — only donor rows (running
    jobs owning single-occupancy GPUs) are ever gathered.
    """

    __slots__ = ("row", "models", "iters", "iters_done", "last_prog",
                 "rate", "blocked", "run_mem", "t_run", "code",
                 "d_rows", "d_jids", "d_singles", "d_slot", "d_count",
                 "_xi_for", "_xi_mats")

    def __init__(self, jobs: List[Job]) -> None:
        n = len(jobs)
        self.row: Dict[int, int] = {}
        self.iters = np.zeros(n, dtype=np.float64)
        self.iters_done = np.zeros(n, dtype=np.float64)
        self.last_prog = np.zeros(n, dtype=np.float64)
        self.rate = np.zeros(n, dtype=np.float64)
        self.blocked = np.zeros(n, dtype=np.float64)
        self.run_mem = np.zeros(n, dtype=np.float64)
        self.t_run = np.zeros(n, dtype=np.float64)
        self.code = np.zeros(n, dtype=np.intp)
        model_index: Dict[str, int] = {}
        for i, job in enumerate(jobs):
            self.row[job.jid] = i
            self.iters[i] = job.iters
            c = model_index.get(job.model)
            if c is None:
                c = model_index.setdefault(job.model, len(model_index))
            self.code[i] = c
        self.models = list(model_index)       # code -> model name
        # donor index: slots [0, d_count) are live, swap-remove on exit
        self.d_rows = np.zeros(n, dtype=np.int64)
        self.d_jids = np.zeros(n, dtype=np.int64)
        self.d_singles = np.zeros(n, dtype=np.int64)
        self.d_slot: Dict[int, int] = {}
        self.d_count = 0
        self._xi_for = None
        self._xi_mats = None

    # -- engine mirror hooks ------------------------------------------- #
    def note_start(self, job: Job, blocked_until: float) -> None:
        r = self.row[job.jid]
        self.iters_done[r] = job.iters_done
        self.last_prog[r] = job.last_progress_at
        self.rate[r] = job.current_rate
        self.blocked[r] = blocked_until
        self.run_mem[r] = job.perf.mem_bytes(job.sub_batch)
        self.t_run[r] = job.solo_t_iter

    def note_progress(self, job: Job) -> None:
        r = self.row[job.jid]
        self.iters_done[r] = job.iters_done
        self.last_prog[r] = job.last_progress_at

    def note_rate(self, job: Job) -> None:
        self.rate[self.row[job.jid]] = job.current_rate

    def note_reconfig(self, job: Job) -> None:
        r = self.row[job.jid]
        self.run_mem[r] = job.perf.mem_bytes(job.sub_batch)
        self.t_run[r] = job.solo_t_iter

    def set_donor_singles(self, jid: int, count: int) -> None:
        """Maintain the donor slots from ClusterState's single-occupancy
        transitions; ``count == 0`` removes the donor (swap-remove)."""
        slot = self.d_slot.get(jid)
        if count:
            if slot is None:
                slot = self.d_count
                self.d_count = slot + 1
                self.d_slot[jid] = slot
                self.d_rows[slot] = self.row[jid]
                self.d_jids[slot] = jid
            self.d_singles[slot] = count
        elif slot is not None:
            last = self.d_count - 1
            if slot != last:
                self.d_rows[slot] = self.d_rows[last]
                self.d_jids[slot] = moved = self.d_jids[last]
                self.d_singles[slot] = self.d_singles[last]
                self.d_slot[int(moved)] = slot
            self.d_count = last
            del self.d_slot[jid]

    def backfill(self, engine) -> None:
        """Capture the engine's current state at attach time (the mirror
        hooks only cover mutations from here on)."""
        blocked = engine._blocked_until
        for job in engine.running.values():
            self.note_start(job, blocked.get(job.jid, 0.0))
        for jid, count in engine.cluster._donor_count.items():
            self.set_donor_singles(jid, count)

    # -- pass-time reads ----------------------------------------------- #
    def donor_rem(self, rows: np.ndarray, now: float) -> np.ndarray:
        """Vectorized mirror of ``EngineBase.remaining_at`` — virtual
        remaining iterations at ``now`` without materializing progress
        (same IEEE-754 expression per lane as the scalar helper)."""
        lp = self.last_prog[rows]
        begin = np.maximum(lp, self.blocked[rows])
        rate = self.rate[rows]
        done = self.iters_done[rows]
        iters = self.iters[rows]
        adv = np.minimum(iters, done + (now - begin) * rate)
        done = np.where((now > begin) & (rate > 0.0), adv, done)
        return np.maximum(0.0, iters - done)

    def xi_universe(self, interference: InterferenceModel):
        """(K x K) xi-constant matrices over the model registry, indexed
        ``[new_model_code, donor_model_code]`` — the grid gathers them
        through the per-job code column. Same lookups as
        ``DonorBatch.xi_terms`` (fixed two-way pairs, one-way table
        hits as NaN-defaulted overrides)."""
        if self._xi_for is interference:
            return self._xi_mats
        models = self.models
        k = len(models)
        fixed = np.zeros((k, k), dtype=bool)
        xi_run = np.ones((k, k), dtype=np.float64)
        xi_new = np.ones((k, k), dtype=np.float64)
        hit_run = np.full((k, k), np.nan, dtype=np.float64)
        hit_new = np.full((k, k), np.nan, dtype=np.float64)
        table = interference.table
        for cn, mn in enumerate(models):          # pending (new) job model
            for cd, md in enumerate(models):      # donor model
                f = interference.pair_fixed(md, mn)
                if f is not None:
                    fixed[cn, cd] = True
                    xi_run[cn, cd], xi_new[cn, cd] = f
                    continue
                hr = table.get((md, mn))
                if hr is not None:
                    hit_run[cn, cd] = hr[0]
                hn = table.get((mn, md))
                if hn is not None:
                    hit_new[cn, cd] = hn[0]
        self._xi_for = interference
        self._xi_mats = (fixed, xi_run, xi_new, hit_run, hit_new)
        return self._xi_mats


class GridPass:
    """Flat pending table + the vectorized Algorithm-1 pass driver.

    Owned by ``SJF_BSBF`` (one per simulation); construction attaches a
    :class:`FlatJobs` mirror to the cluster and backfills it. The table
    is append-only with lazy compaction: arrivals are ingested from the
    engine's arrival cursor, placed rows are tombstoned, and any
    preemption (detected via ``engine.preemptions_total``) rebuilds the
    table because requeued jobs carry changed sort keys.
    """

    def __init__(self, sim) -> None:
        self.sim = sim
        engine = sim.engine
        cluster = sim.cluster
        flat = cluster._flat
        if flat is None:
            flat = FlatJobs(list(sim.jobs.values()))
            cluster._flat = flat
            flat.backfill(engine)
        self.flat: FlatJobs = flat
        cap = max(16, len(sim.jobs) or 1)
        self._cap = cap
        self._cmax = 8
        self._n = 0
        self._dead = 0
        self._keys = np.zeros(cap, dtype=np.float64)
        self._jids = np.zeros(cap, dtype=np.int64)
        self._want = np.zeros(cap, dtype=np.int64)
        self._iters = np.zeros(cap, dtype=np.float64)
        self._code = np.zeros(cap, dtype=np.intp)
        self._alive = np.zeros(cap, dtype=bool)
        self._tab = np.zeros(cap, dtype=bool)   # candidate row filled?
        self._bs = np.ones((cap, self._cmax), dtype=np.int64)
        self._tn = np.ones((cap, self._cmax), dtype=np.float64)
        self._mem = np.full((cap, self._cmax), np.inf, dtype=np.float64)
        self._jobs: List = []
        self._seen = 0
        self._pstamp = -1
        self._rebuild(sim)

    # -- table maintenance --------------------------------------------- #
    def _grow_rows(self) -> None:
        cap = self._cap * 2
        for name in ("_keys", "_jids", "_want", "_iters", "_code",
                     "_alive", "_tab"):
            old = getattr(self, name)
            new = np.zeros(cap, dtype=old.dtype)
            new[: self._n] = old[: self._n]
            setattr(self, name, new)
        for name, fill in (("_bs", 1), ("_tn", 1.0), ("_mem", np.inf)):
            old = getattr(self, name)
            new = np.full((cap, self._cmax), fill, dtype=old.dtype)
            new[: self._n] = old[: self._n]
            setattr(self, name, new)
        self._cap = cap

    def _grow_candidates(self, need: int) -> None:
        cmax = self._cmax
        while cmax < need:
            cmax *= 2
        for name, fill in (("_bs", 1), ("_tn", 1.0), ("_mem", np.inf)):
            old = getattr(self, name)
            new = np.full((self._cap, cmax), fill, dtype=old.dtype)
            new[:, : self._cmax] = old
            setattr(self, name, new)
        self._cmax = cmax

    def _append(self, job: Job) -> None:
        if self._n == self._cap:
            self._grow_rows()
        i = self._n
        self._n = i + 1
        self._keys[i] = job.expected_remaining_time
        self._jids[i] = job.jid
        self._want[i] = job.alloc_gpus or job.gpus
        self._iters[i] = job.iters
        self._code[i] = self.flat.code[self.flat.row[job.jid]]
        self._alive[i] = True
        # candidate table built lazily on the job's first share decision
        # — most jobs start exclusively and never need one
        self._tab[i] = False
        self._jobs.append(job)

    def _fill_tables(self, rows: np.ndarray) -> None:
        for i in rows:
            bs, _ss, tn, mem = job_candidate_table(self._jobs[i])
            c = len(bs)
            if c > self._cmax:
                self._grow_candidates(c)
            self._bs[i, :c] = bs
            self._bs[i, c:] = 1
            self._tn[i, :c] = tn
            self._tn[i, c:] = 1.0
            self._mem[i, :c] = mem
            self._mem[i, c:] = np.inf
        self._tab[rows] = True

    def _kill(self, i: int) -> None:
        self._alive[i] = False
        self._jobs[i] = None
        self._dead += 1

    def _maybe_compact(self) -> None:
        # amortized: tiny tables tolerate tombstones, so only sweep once
        # enough rows are dead to halve the walk. Callers must not hold
        # row indices across this (compaction renumbers rows).
        if self._dead >= 16 and self._dead * 2 > self._n:
            self._compact()

    def _compact(self) -> None:
        n = self._n
        mask = self._alive[:n]
        live = int(mask.sum())
        for name in ("_keys", "_jids", "_want", "_iters", "_code", "_tab"):
            arr = getattr(self, name)
            arr[:live] = arr[:n][mask]
        for name in ("_bs", "_tn", "_mem"):
            arr = getattr(self, name)
            arr[:live] = arr[:n][mask]
        self._jobs = [j for j in self._jobs if j is not None]
        self._alive[:live] = True
        self._n = live
        self._dead = 0

    def _rebuild(self, sim) -> None:
        engine = sim.engine
        self._n = 0
        self._dead = 0
        self._jobs = []
        self._alive[:] = False
        for job in engine.pending:
            if job.state is JobState.PENDING:
                self._append(job)
        self._seen = engine._arrival_idx
        self._pstamp = engine.preemptions_total

    def _ingest(self, engine) -> None:
        idx = engine._arrival_idx
        if idx > self._seen:
            arrivals = engine.arrivals
            for k in range(self._seen, idx):
                job = arrivals[k]
                if job.state is JobState.PENDING:
                    self._append(job)
            self._seen = idx

    # -- grid decisions ------------------------------------------------ #
    def _decide(self, cand: np.ndarray, interference: InterferenceModel,
                cap: float, now: float):
        """Algorithm 2 / Theorem 1 for pending rows ``cand`` x all
        donors; returns ``(share, avg, sub, d_jids, d_singles)`` with
        the leading axis aligned to ``cand``. Mirrors
        ``pair_batch.best_sharing_configs`` expression-for-expression
        (the broadcasts only add a pending axis), so every row is
        bitwise identical to the per-job batched/scalar result."""
        flat = self.flat
        dn = flat.d_count
        drow = flat.d_rows[:dn]
        d_jids = flat.d_jids[:dn].copy()
        d_singles = flat.d_singles[:dn].copy()
        run_mem = flat.run_mem[drow]
        t_run = flat.t_run[drow]
        rem = flat.donor_rem(drow, now)
        codes_d = flat.code[drow]
        codes_p = self._code[cand]
        fixed_m, xi_run_m, xi_new_m, hit_run_m, hit_new_m = \
            flat.xi_universe(interference)
        fixed_pd = fixed_m[codes_p[:, None], codes_d[None, :]]
        xr = xi_run_m[codes_p[:, None], codes_d[None, :]]
        xn = xi_new_m[codes_p[:, None], codes_d[None, :]]
        p = cand.size
        cmax = self._cmax
        share = np.empty((p, dn), dtype=bool)
        avg = np.empty((p, dn), dtype=np.float64)
        sub = np.empty((p, dn), dtype=np.int64)
        all_fixed = bool(fixed_pd.all())
        step = max(1, _CHUNK_ELEMS // max(1, dn * cmax))
        for s in range(0, p, step):
            e = min(p, s + step)
            rows = cand[s:e]
            mem_rows = self._mem[rows]            # (c, C), +inf padded
            tn_rows = self._tn[rows]
            bs_rows = self._bs[rows]
            it_rows = self._iters[rows]
            feasible = (mem_rows[:, None, :] + run_mem[None, :, None]
                        <= cap)                    # (c, D, C)
            any_f = feasible.any(axis=2)
            first_idx = np.argmax(feasible, axis=2)
            if all_fixed:
                # first-feasible (largest) sub-batch is optimal when xi
                # is sub-batch independent — same shortcut as the
                # scalar sweep's break and pair_batch's fixed branch
                sel = first_idx
                tn_sel = np.take_along_axis(tn_rows, sel, axis=1)
                sh, av, _t0, _t1, _t2, _t3 = _theorem1(
                    t_run[None, :], rem[None, :], xr[s:e], tn_sel,
                    it_rows[:, None], xn[s:e])
            else:
                hr = hit_run_m[codes_p[s:e, None], codes_d[None, :]]
                hn = hit_new_m[codes_p[s:e, None], codes_d[None, :]]
                fx = fixed_pd[s:e]
                t_new_g = tn_rows[:, None, :]
                mem_frac = (run_mem[None, :, None]
                            + mem_rows[:, None, :]) / cap
                xi_run_g = _structural_xi(interference,
                                          t_run[None, :, None], t_new_g,
                                          mem_frac)
                xi_new_g = _structural_xi(interference, t_new_g,
                                          t_run[None, :, None], mem_frac)
                run_const = fx | ~np.isnan(hr)
                new_const = fx | ~np.isnan(hn)
                run_val = np.where(fx, xr[s:e], hr)
                new_val = np.where(fx, xn[s:e], hn)
                xi_run_g = np.where(run_const[:, :, None],
                                    run_val[:, :, None], xi_run_g)
                xi_new_g = np.where(new_const[:, :, None],
                                    new_val[:, :, None], xi_new_g)
                sh_g, av_g, _t0, _t1, _t2, _t3 = _theorem1(
                    t_run[None, :, None], rem[None, :, None], xi_run_g,
                    t_new_g, it_rows[:, None, None], xi_new_g)
                av_m = np.where(feasible, av_g, np.inf)
                sel = np.where(fx, first_idx, np.argmin(av_m, axis=2))
                sh = np.take_along_axis(sh_g, sel[:, :, None],
                                        axis=2)[:, :, 0]
                av = np.take_along_axis(av_g, sel[:, :, None],
                                        axis=2)[:, :, 0]
            # quench donors with no feasible candidate (scalar sentinel)
            share[s:e] = sh & any_f
            avg[s:e] = np.where(any_f, av, np.inf)
            sub[s:e] = np.take_along_axis(bs_rows, sel, axis=1)
        return share, avg, sub, d_jids, d_singles

    def _start_shared(self, sim, job, want_i: int, share_row, avg_row,
                      sub_row, d_jids) -> None:
        """Place ``job`` on its benefit donors' single-occupancy GPUs —
        the exact placement loop of the scalar path (Algorithm 1 lines
        14-17): donors by pair-JCT ascending (ties by jid), shared GPUs
        first, smallest free ids fill the remainder."""
        cluster = sim.cluster
        jobs_by_id = sim.jobs
        occupancy = cluster.occupancy
        sidx = np.flatnonzero(share_row)
        order = sidx[np.lexsort((d_jids[sidx], avg_row[sidx]))]
        chosen: List[int] = []
        sub_b = job.batch
        for t in order:
            if len(chosen) >= want_i:
                break
            run = jobs_by_id[int(d_jids[t])]
            for gg in sorted(run.placement):
                if len(occupancy[gg]) == 1:
                    chosen.append(gg)
                    if len(chosen) >= want_i:
                        break
            sub_b = min(sub_b, int(sub_row[t]))
        if len(chosen) < want_i:
            chosen.extend(cluster.smallest_free(want_i - len(chosen)))
        sim.start_job(job, chosen[:want_i], sub_batch=sub_b)

    def _schedule_small(self, sim, start_exclusive) -> None:
        """Scalar mirror of the masked-argmin walk for tiny queues: a
        sorted (key, jid) walk visiting each row once is exactly what
        the floor-protected argmin produces, and per-row decisions go
        through the same :meth:`_decide` grid — so the schedules are
        bit-identical while skipping ~10 array ops per placement."""
        engine = sim.engine
        cluster = sim.cluster
        interference = sim.interference
        cap = cluster.gpu_capacity_bytes
        flat = self.flat
        keys = self._keys
        jids = self._jids
        rows = [i for i in range(self._n) if self._alive[i]]
        rows.sort(key=lambda i: (keys[i], jids[i]))
        for i in rows:
            job = self._jobs[i]
            if job is None or job.state is not JobState.PENDING:
                self._kill(i)           # defensive: stale row
                continue
            want_i = int(self._want[i])
            n_free = cluster.n_free
            if want_i <= n_free:
                started = start_exclusive(sim, job)
                assert started
                self._kill(i)
                continue
            n_single = cluster.n_single
            if (not n_single or not flat.d_count
                    or want_i > n_free + n_single):
                continue                 # Line 9 fails: stay pending
            ci = np.array([i], dtype=np.intp)
            if not self._tab[i]:
                self._fill_tables(ci)
            share, avg, sub, d_jids, d_singles = self._decide(
                ci, interference, cap, engine.time)
            share_row = share[0]
            if int((share_row * d_singles).sum()) + n_free < want_i:
                continue                 # SF False / not enough singles
            self._start_shared(sim, job, want_i, share_row, avg[0],
                               sub[0], d_jids)
            self._kill(i)
        self._maybe_compact()

    # -- the pass ------------------------------------------------------ #
    def schedule(self, sim, start_exclusive) -> None:
        engine = sim.engine
        if engine.preemptions_total != self._pstamp:
            self._rebuild(sim)
        else:
            self._ingest(engine)
        if self._n == self._dead:
            return
        if self._n - self._dead <= 8:
            self._schedule_small(sim, start_exclusive)
            return
        cluster = sim.cluster
        interference = sim.interference
        cap = cluster.gpu_capacity_bytes
        flat = self.flat
        floor_key = -np.inf
        floor_jid = -1
        while True:
            n = self._n
            alive = self._alive[:n]
            keys = self._keys[:n]
            jids = self._jids[:n]
            want = self._want[:n]
            beyond = alive & ((keys > floor_key)
                              | ((keys == floor_key) & (jids > floor_jid)))
            if not beyond.any():
                return
            n_free = cluster.n_free
            n_single = cluster.n_single
            actionable = beyond & (want <= n_free)
            grid = None
            cand = None
            if n_single and flat.d_count:
                cand = np.flatnonzero(beyond & (want > n_free)
                                      & (want <= n_free + n_single))
                if cand.size:
                    need = cand[~self._tab[cand]]
                    if need.size:
                        self._fill_tables(need)
                    grid = self._decide(cand, interference, cap,
                                        engine.time)
                    share = grid[0]
                    d_singles = grid[4]
                    gain = (share * d_singles[None, :]).sum(axis=1)
                    ok = gain + n_free >= want[cand]
                    if ok.any():
                        actionable = actionable.copy()
                        actionable[cand[ok]] = True
            idx = np.flatnonzero(actionable)
            if idx.size == 0:
                return
            k = keys[idx]
            m = k.min()
            ties = idx[k == m]
            i = int(ties[np.argmin(jids[ties])]) if ties.size > 1 \
                else int(ties[0])
            job = self._jobs[i]
            if job is None or job.state is not JobState.PENDING:
                self._kill(i)           # defensive: stale row
                continue
            floor_key = float(keys[i])
            floor_jid = int(jids[i])
            if int(want[i]) <= n_free:
                started = start_exclusive(sim, job)
                assert started
            else:
                share, avg, sub, d_jids, _sing = grid
                g = int(np.searchsorted(cand, i))
                self._start_shared(sim, job, int(want[i]), share[g],
                                   avg[g], sub[g], d_jids)
            self._kill(i)
            self._maybe_compact()
