"""Slot-based continuous batching (the reference's ``launch/engine.py``):
the serving twin of the simulator's sharing scheduler.

A ``DecodeEngine`` owns a fixed number of decode *slots* (the batch
dimension of one shared cache) and a FIFO queue of requests. Decoding
advances all slots together in segments of ``segment`` tokens, with the
per-slot absolute positions in the cache's ``index`` vector and every
token kept on the device until the segment ends (one copy to the host per
segment). Between segments finished slots are freed and queued requests
admitted: each admission prefills its request alone and writes the
resulting cache rows into the slot (dense) or into pool pages (paged), so
a reused slot never sees the previous occupant's rows.

Idle slots keep stepping; their tokens are discarded. Their K/V writes
never land where a request reads: a dense slot's index may run past
``max_len`` and its write is dropped (``attention._scatter_rows``), a
paged slot with no page writes into the pool's scratch page, and a ring
buffer's idle slot writes into its own ring, which the next admission
overwrites whole. The hybrid's Mamba2 conv windows and SSM states are
per slot in both layouts: an idle slot's keep stepping, and an admission
overwrites them with its own prefill's.

The dense, vlm, moe, hybrid and ssm families; an encoder-decoder
(audio) is served by ``serve.generate`` and refused here, as in the
reference. The ssm family's mLSTM and sLSTM states are per slot, like
the hybrid's: an admission overwrites them with its own prefill's
(the sLSTM's ``n`` with the prefill's, never 0). A sliding window's ring
buffer serves in the dense mode; paging needs the linear layout, which
the ssm family does not have. Prefix sharing for dense and vlm, and for
moe under the dense dispatch, as in the reference. Degraded mode as in the
reference: per-request deadlines with timeout shedding, admission
brown-out, and bounded retry of transient segment faults
(``fault_injector``, ``retry_policy``), all off by default.
"""
from __future__ import annotations

import dataclasses
import random
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.launch.cluster import ScriptedFaults, TransientFault
from repro_torch.launch.prefix import PrefixTrie
from repro_torch.launch.serve import (_device, _make_scan_generate,
                                      prefill_extend_cached)
from repro_torch.models import init_cache, init_paged_cache, prefill
from repro_torch.models.model import has_linear_kv
from repro_torch.tree import flatten
from repro_torch.util.retry import RetryPolicy, retry_call


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (plen,) int
    max_new_tokens: int
    deadline: Optional[float] = None   # absolute clock time; None = none
    priority: int = 0                  # higher = more important
    submitted_at: float = 0.0


class DecodeEngine:
    """Continuous-batching decode engine over ``n_slots`` fixed slots, on
    the device of ``params``.

    ``paged=True`` swaps the dense per-slot KV cache for a shared page
    pool plus per-slot block tables: a slot holds only the pages its
    request occupies. A request is admitted only when its worst-case page
    count (prompt + all decode segments) is available as credit; pages
    are assigned lazily, one segment ahead of the decode index, and
    reclaimed when the slot frees.

    ``prefix_share=True`` adds copy-on-write prefix sharing on top of
    paging: a radix trie over token IDs maps each prompt to its longest
    cached prefix, whose pages are mapped read-only into the new slot
    (per-page refcounts; a page is writable only at refcount 1).
    Admission charges credit only for the request's unique pages, prefill
    computes only the un-cached suffix, and the first decode write into a
    still-shared boundary page forks that page. Zero-ref cached prefixes
    are reclaimed LRU under the ``retain_pages`` watermark, and eagerly
    under brown-out. On the card a miss prefills through the flash
    forward kernel and a hit prefills its suffix through the same kernel
    at a query offset, so each attention row matches the miss's bits;
    decode takes the paged flash-decode kernel.

    ``debug=True`` audits the paging invariants every segment.

    ``fault_injector`` is consulted before every segment (as job
    ``"segment"``, call = segments done); a :class:`TransientFault` is
    retried under ``retry_policy`` and counted in ``stats["retries"]``,
    and one that outlasts the policy propagates."""

    def __init__(self, cfg, params, *, n_slots: int = 4, max_len: int = 256,
                 segment: int = 8, paged: bool = False, page_size: int = 16,
                 n_pages: Optional[int] = None, prefix_share: bool = False,
                 retain_pages: Optional[int] = None, debug: bool = False,
                 clock=time.monotonic, brownout_depth: int = 0,
                 fault_injector: Optional[ScriptedFaults] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 retry_seed: int = 0, sleep=time.sleep):
        if cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.name} is an encoder-decoder; it is "
                             f"served by serve.generate, not the engine")
        if prefix_share:
            if not paged:
                raise ValueError("prefix_share requires paged=True")
            # bitwise contract: the suffix prefill (prefill_extend) gives
            # the full prefill's rows. It does for dense and vlm attention
            # and for MoE under the per-token "dense" dispatch; the einsum
            # and scatter dispatches size their capacity by the sequence
            # length, and the hybrid's recurrent state is not
            # page-addressable at all
            if cfg.family == "moe" and cfg.moe_dispatch != "dense":
                raise ValueError(
                    f"prefix_share needs a bitwise-stable suffix prefill; "
                    f"MoE under moe_dispatch {cfg.moe_dispatch!r} sizes its "
                    f"capacity by the sequence length (only 'dense' does "
                    f"not)")
            if cfg.family not in ("dense", "vlm", "moe"):
                raise ValueError(
                    f"prefix_share needs a bitwise-stable suffix prefill; "
                    f"family {cfg.family!r} carries recurrent state across "
                    f"positions and has none")
        if paged and not has_linear_kv(cfg):
            raise ValueError(
                f"paged KV requires a linear-layout KV cache; family "
                f"{cfg.family!r} (window {cfg.sliding_window}) has none")
        self.cfg, self.params = cfg, params
        self.device = _device(params)
        self.n_slots, self.max_len, self.segment = n_slots, max_len, segment
        self.paged = paged
        self.prefix_share = prefix_share
        self.debug = debug

        if paged:
            if n_pages is None:     # dense-equivalent memory by default
                n_pages = n_slots * (max_len // page_size)
            self.page_size, self.n_pages = page_size, n_pages
            cache = init_paged_cache(cfg, n_slots, max_len,
                                     page_size=page_size, n_pages=n_pages,
                                     device=self.device)
            # host-side paging state
            self._free_pages: List[int] = list(range(n_pages))
            self._pages_np = np.full((n_slots, max_len // page_size), -1,
                                     np.int32)
            self._slot_npages = np.zeros(n_slots, np.int64)  # assigned
            self._slot_reserve = np.zeros(n_slots, np.int64)  # total credit
            self._slot_unique = np.zeros(n_slots, np.int64)  # non-shared
            self._index_np = np.zeros(n_slots, np.int64)     # decode pos
            # per-page refcounts: one per mapped block-table entry plus
            # one per trie node. Free <=> 0; writable by a slot <=> 1.
            self._page_refs = np.zeros(n_pages, np.int32)
            # outstanding credit: sum over slots of (reserve - unique)
            self._committed = 0
            self._trie = PrefixTrie(page_size) if prefix_share else None
            self.retain_pages = (n_pages if retain_pages is None
                                 else int(retain_pages))
        else:
            cache = init_cache(cfg, n_slots, max_len, device=self.device)
        cache["index"] = torch.zeros(n_slots, dtype=torch.long,
                                     device=self.device)
        self.cache = cache
        self.tok = torch.zeros((n_slots, 1), dtype=torch.long,
                               device=self.device)      # next input token
        self.active = np.zeros(n_slots, bool)
        self.remaining = np.zeros(n_slots, np.int64)
        self.slot_rid: List[int] = [-1] * n_slots

        self.queue: deque = deque()
        self.outputs: Dict[int, List[int]] = {}
        self._next_rid = 0
        self._segment_fn = self._make_segment_fn()
        # degraded-mode serving: per-request deadlines with timeout
        # shedding, admission brown-out under overload, and bounded retry
        # of transient segment faults; all off by default
        self._clock = clock
        self.brownout_depth = int(brownout_depth)
        self.fault_injector = fault_injector
        self.retry_policy = retry_policy or RetryPolicy()
        self._retry_rng = random.Random(retry_seed)
        self._sleep = sleep
        self.slot_deadline: List[Optional[float]] = [None] * n_slots
        self.shed: Dict[int, str] = {}            # rid -> shed reason
        self.retry_after: Dict[int, float] = {}   # rid -> backoff hint (s)
        self._seg_ewma = 0.0                      # EWMA segment walltime
        self.stats = {"segments": 0, "admitted": 0, "wasted_slot_steps": 0,
                      "peak_active_slots": 0, "shed_deadline": 0,
                      "shed_brownout": 0, "deadline_miss": 0, "retries": 0,
                      "decode_seconds": 0.0}
        if paged:
            self.stats.update({
                "pages_total": n_pages, "pages_in_use": 0,
                "peak_pages_in_use": 0, "page_occupancy": 0.0,
                "page_fragmentation": 0.0, "admission_deferred_pages": 0})
        if prefix_share:
            self.stats.update({
                "prefix_hits": 0, "prefix_misses": 0,
                "prefix_hit_rate": 0.0, "prefill_tokens_saved": 0,
                "prompt_tokens_total": 0, "cow_forks": 0,
                "prefix_evictions": 0, "brownout_prefix_evictions": 0,
                "shared_pages": 0, "unique_pages": 0, "trie_pages": 0})

    # -- page credit / refcounts ---------------------------------------- #
    @property
    def _avail_pages(self) -> int:
        """Admission credit: physically free pages minus outstanding
        reservations, plus pages reclaimable from zero-ref cached
        prefixes. Without prefix sharing this equals ``n_pages -
        sum(reservations)``."""
        avail = len(self._free_pages) - self._committed
        if self.prefix_share:
            avail += self._trie.evictable_pages(self._page_refs)
        return avail

    def _take_page(self) -> int:
        """Pop a physically free page (refcount 0 -> 1), evicting the LRU
        zero-ref cached prefix page first if the free list is dry. An
        IndexError here means the reservation credit was violated."""
        if not self._free_pages and self.prefix_share:
            page = self._trie.evict_lru(self._page_refs)
            if page is not None:
                self._page_refs[page] -= 1
                self._free_pages.append(page)
                self.stats["prefix_evictions"] += 1
        page = self._free_pages.pop()
        self._page_refs[page] = 1
        return page

    # ------------------------------------------------------------------ #
    def submit(self, prompt, max_new_tokens: int = 16, *,
               deadline: Optional[float] = None, priority: int = 0) -> int:
        """Queue a request; returns its id (key into ``outputs``).

        ``deadline`` is relative (seconds from now on the engine clock): a
        request that has not completed by then is shed, from the queue or
        mid-decode, with its rid recorded in ``shed`` and a
        ``retry_after`` hint. ``priority`` orders brown-out shedding
        (lower priorities shed first); admission itself stays FIFO."""
        prompt = np.asarray(prompt, np.int64)
        if has_linear_kv(self.cfg):
            # a linear cache holds one row per prompt + generated token,
            # and a slot steps to the end of its last segment; a ring
            # buffer wraps
            segs = -(-max_new_tokens // self.segment)
            need = prompt.shape[0] + segs * self.segment
            if need > self.max_len:
                raise ValueError(
                    f"request needs {need} cache rows (prompt "
                    f"{prompt.shape[0]} + {segs}x{self.segment}-step "
                    f"segments) but max_len is {self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        now = self._clock()
        self.queue.append(Request(
            rid, prompt, max_new_tokens,
            deadline=(now + deadline) if deadline is not None else None,
            priority=int(priority), submitted_at=now))
        self.outputs[rid] = []
        return rid

    # -- degraded mode --------------------------------------------------- #
    def _retry_after_hint(self) -> float:
        """Back-pressure hint for a shed request: the EWMA segment
        walltime times the queue depth."""
        return self._seg_ewma * (1 + len(self.queue))

    def _shed_request(self, rid: int, reason: str) -> None:
        self.shed[rid] = reason
        self.retry_after[rid] = self._retry_after_hint()
        self.stats["shed_" + reason] += 1

    def _free_slot(self, slot: int) -> None:
        self.active[slot] = False
        self.slot_rid[slot] = -1
        self.slot_deadline[slot] = None
        self.remaining[slot] = 0
        if self.paged:
            self._free_slot_pages(slot)

    def _shed_expired(self, now: float) -> None:
        """Queued requests past their deadline never admit; active slots
        past theirs free at once (the partial output stays in
        ``outputs``)."""
        kept = deque()
        for req in self.queue:
            if req.deadline is not None and now > req.deadline:
                self._shed_request(req.rid, "deadline")
            else:
                kept.append(req)
        self.queue = kept
        for slot in range(self.n_slots):
            dl = self.slot_deadline[slot]
            if self.active[slot] and dl is not None and now > dl:
                self._shed_request(self.slot_rid[slot], "deadline")
                self._free_slot(slot)

    def _admissible_now(self) -> int:
        """How many queued requests (a FIFO prefix) could be admitted now
        into free slots with the current page credit."""
        free_slots = int((~self.active).sum())
        avail, n = self._avail_pages, 0
        for req in self.queue:
            if n >= free_slots:
                break
            reserve, _ = self._plan_admission(req, touch=False)
            if reserve > avail:
                break
            avail -= reserve
            n += 1
        return n

    def _brownout(self) -> None:
        """When the queue is deeper than ``brownout_depth``, shed the
        lowest-priority (then youngest) queued requests until it fits.
        With prefix sharing, every zero-ref cached prefix is evicted
        first (counted in ``brownout_prefix_evictions``) and only the
        requests beyond what the freed pages can admit are dropped."""
        if self.brownout_depth <= 0 or len(self.queue) <= self.brownout_depth:
            return
        if self.prefix_share:
            while True:
                page = self._trie.evict_lru(self._page_refs)
                if page is None:
                    break
                self._page_refs[page] -= 1
                self._free_pages.append(page)
                self.stats["brownout_prefix_evictions"] += 1
            excess = (len(self.queue) - self._admissible_now()
                      - self.brownout_depth)
            if excess <= 0:
                return
        else:
            excess = len(self.queue) - self.brownout_depth
        order = sorted(self.queue,
                       key=lambda r: (r.priority, -r.submitted_at))
        drop = {r.rid for r in order[:excess]}
        kept = deque()
        for req in self.queue:
            if req.rid in drop:
                self._shed_request(req.rid, "brownout")
            else:
                kept.append(req)
        self.queue = kept

    # ------------------------------------------------------------------ #
    def _make_segment_fn(self):
        """One greedy segment of ``segment`` decode steps, continuing the
        carry: serve's device-side loop, (params, cache, tok) -> (tokens
        (n_slots, segment), cache, next tok)."""
        return _make_scan_generate(self.cfg, self.segment, True)

    def _prefill_fn(self, prompt: np.ndarray):
        """Solo one-shot prefill of one request into a fresh batch-1
        cache of ``max_len`` rows."""
        cache = init_cache(self.cfg, 1, self.max_len, device=self.device)
        tokens = torch.as_tensor(prompt, device=self.device)[None, :]
        return prefill(self.cfg, self.params, cache, tokens)

    def _gather_fn(self, pids: List[int]):
        """Copy pool pages ``pids`` into rows ``[0, len(pids) *
        page_size)`` of a fresh batch-1 dense cache: the launchpad for the
        suffix prefill."""
        cache = init_cache(self.cfg, 1, self.max_len, device=self.device)
        idx = torch.as_tensor(pids, device=self.device)
        n = len(pids) * self.page_size
        dense = flatten(cache["units"])
        for key, pool in _pools(self.cache["units"]):
            u = pool.shape[0]              # pool: (U, n_pages + 1, ps, H, D)
            rows = pool[:, idx].reshape((u, n) + pool.shape[3:])
            dense[key][:, 0, :n] = rows
        return cache

    # ------------------------------------------------------------------ #
    def _pages_needed(self, req: Request) -> int:
        """Worst-case page count: one row per prompt token plus every
        position its slot steps through (whole segments)."""
        segs = -(-req.max_new_tokens // self.segment)
        rows = req.prompt.shape[0] + segs * self.segment
        return -(-rows // self.page_size)

    def _plan_admission(self, req: Request, *, touch: bool = True):
        """Reservation and prefix plan for one request: ``(reserve,
        match)``. Without prefix sharing ``reserve`` is the worst-case
        page count and ``match`` None. With it, ``match = (pages_m, L,
        f)``: ``L`` the usable matched prefix length and ``f`` the
        fully shared page count; ``reserve`` charges only the unique
        pages plus a one-page boundary-fork allowance when the prompt ends
        mid-page. ``L`` is capped at ``plen - 2``, as in the reference,
        so the suffix prefill always recomputes at least two rows."""
        total = self._pages_needed(req)
        if not self.prefix_share:
            return total, None
        ps = self.page_size
        plen = req.prompt.shape[0]
        pages_m, matched = self._trie.match(req.prompt, touch=touch)
        L = max(0, min(matched, plen - 2))
        f = L // ps
        reserve = total - f + (1 if plen % ps else 0)
        return reserve, (pages_m, L, f)

    def _admit(self) -> None:
        """Fill every free slot from the queue: solo prefill, then write
        the request's cache rows into the slot (dense) or into freshly
        assigned pool pages (paged). Paged admission is credit-gated
        (FIFO: an oversized head blocks the queue), so ``_grow`` never
        runs out of pages mid-flight. The first token stays on the
        device: it is the first token the next segment emits."""
        for slot in range(self.n_slots):
            if self.active[slot] or not self.queue:
                continue
            if self.paged:
                req = self.queue[0]
                reserve, match = self._plan_admission(req)
                if reserve > self._avail_pages:
                    self.stats["admission_deferred_pages"] += 1
                    break
                self.queue.popleft()
                logits = self._admit_paged(slot, req, reserve, match)
            else:
                req = self.queue.popleft()
                logits, pcache = self._prefill_fn(req.prompt)
                _scatter_slot(self.cache["units"], pcache["units"], slot)
            self.cache["index"][slot] = req.prompt.shape[0]
            self.tok[slot, 0] = torch.argmax(logits[0, -1])
            self.active[slot] = True
            self.remaining[slot] = req.max_new_tokens
            self.slot_rid[slot] = req.rid
            self.slot_deadline[slot] = req.deadline
            self.stats["admitted"] += 1

    def _admit_paged(self, slot: int, req: Request, reserve: int, match):
        """Map the fully matched shared prefix pages read-only (refcount
        +1, no credit), take unique pages for the rest, prefill only the
        un-cached suffix (gathered through a fresh dense cache), write the
        suffix rows and publish the prompt's pages into the trie."""
        ps = self.page_size
        plen = req.prompt.shape[0]
        npf = -(-plen // ps)
        pages_m, L, f = match if match is not None else ([], 0, 0)

        self._pages_np[slot, :] = -1
        for j in range(f):                      # shared prefix, read-only
            p = int(pages_m[j])
            self._pages_np[slot, j] = p
            self._page_refs[p] += 1
        for j in range(f, npf):                 # private suffix pages
            self._pages_np[slot, j] = self._take_page()
        self._slot_npages[slot] = npf
        self._slot_reserve[slot] = reserve
        self._slot_unique[slot] = npf - f
        self._committed += reserve - (npf - f)
        self._index_np[slot] = plen

        if L > 0:
            # gather every page with matched rows, including a partially
            # matched boundary page (a read source only, never mapped),
            # then extend from row L
            gathered = self._gather_fn(
                [int(p) for p in pages_m[:-(-L // ps)]])
            tokens = torch.as_tensor(req.prompt[L:], device=self.device)
            logits, pcache = prefill_extend_cached(
                self.cfg, self.params, gathered, tokens[None, :], start=L)
            self.stats["prefix_hits"] += 1
            self.stats["prefill_tokens_saved"] += L
        else:
            logits, pcache = self._prefill_fn(req.prompt)
            if self.prefix_share:
                self.stats["prefix_misses"] += 1
        if self.prefix_share:
            self.stats["prompt_tokens_total"] += plen
        self._scatter_paged(pcache["units"],
                            [int(p) for p in self._pages_np[slot, f:npf]],
                            slot, first_page=f)
        if self.prefix_share:
            for p in self._trie.insert(
                    req.prompt, [int(x) for x in self._pages_np[slot, :npf]]):
                self._page_refs[p] += 1
            self._trim_trie()
        return logits

    def _scatter_paged(self, punits, pids: List[int], slot: int, *,
                       first_page: int = 0) -> None:
        """Write a solo prefill cache into the paged engine cache: the
        pools take the prompt's rows into pages ``pids``, page by page from
        prompt page ``first_page`` (the shared prefix pages before it are
        already filled); per-slot leaves (the hybrid's Mamba2 state) go
        into slot ``slot`` as in the dense engine."""
        ps, n = self.page_size, len(pids)
        idx = torch.as_tensor(pids, device=self.device)
        lo = first_page * ps
        srcs = flatten(punits)
        for key, dst in flatten(self.cache["units"]).items():
            src = srcs[key]
            if not _is_pool(key):
                _scatter_slot_leaf(dst, src, slot)
                continue
            rows = src[:, 0, lo:lo + n * ps]     # src: (U, 1, max_len, H, D)
            dst[:, idx] = rows.reshape((src.shape[0], n, ps)
                                       + src.shape[3:]).to(dst.dtype)

    def _fork_page(self, slot: int, j: int) -> None:
        """Copy-on-write: give ``slot`` a private copy of block-table entry
        ``j`` before it writes into a still-shared page. Only the boundary
        page of a freshly published prompt can hit this, and its admission
        pre-charged the fork allowance."""
        old = int(self._pages_np[slot, j])
        new = self._take_page()                 # refs[new] = 1
        self._page_refs[old] -= 1
        for _, pool in _pools(self.cache["units"]):
            pool[:, new] = pool[:, old]
        self._pages_np[slot, j] = new
        self._slot_unique[slot] += 1
        self._committed -= 1
        self.stats["cow_forks"] += 1

    def _grow(self) -> None:
        """Assign pool pages covering the upcoming segment for every
        active slot, against the admission reservation; with prefix
        sharing, fork any still-shared page the segment will write."""
        ps = self.page_size
        for slot in range(self.n_slots):
            if not self.active[slot]:
                continue
            idx = int(self._index_np[slot])
            pend = -(-(idx + self.segment) // ps)
            if self.prefix_share:
                for j in range(idx // ps, min(pend,
                                              int(self._slot_npages[slot]))):
                    if self._page_refs[int(self._pages_np[slot, j])] > 1:
                        self._fork_page(slot, j)
            while self._slot_npages[slot] < pend:
                self._pages_np[slot, self._slot_npages[slot]] = \
                    self._take_page()
                self._slot_npages[slot] += 1
                self._slot_unique[slot] += 1
                self._committed -= 1

    def _paging_stats(self) -> None:
        in_use = int(self._slot_npages.sum())
        self.stats["pages_in_use"] = in_use
        self.stats["peak_pages_in_use"] = max(
            self.stats["peak_pages_in_use"], in_use)
        rows = int((self._index_np[self.active] + self.segment).sum())
        occ = rows / (in_use * self.page_size) if in_use else 0.0
        self.stats["page_occupancy"] = occ
        self.stats["page_fragmentation"] = 1.0 - occ
        if self.prefix_share:
            refs = self._page_refs
            self.stats["shared_pages"] = int((refs > 1).sum())
            self.stats["unique_pages"] = int((refs == 1).sum())
            self.stats["trie_pages"] = self._trie.page_count()
            h, m = self.stats["prefix_hits"], self.stats["prefix_misses"]
            self.stats["prefix_hit_rate"] = h / (h + m) if h + m else 0.0

    def step_segment(self) -> None:
        """One segment plus the bookkeeping around it: expired requests
        shed and the queue brown-outs, admission refills the free slots,
        the segment decodes, and finished slots free."""
        self._shed_expired(self._clock())
        self._brownout()
        self._admit()
        if self.paged:
            self._grow()
            # one host->device copy of the (n_slots, P) block table per
            # segment covers admissions, growth and last-segment frees
            self.cache["pages"] = torch.as_tensor(self._pages_np,
                                                  device=self.device)
            self._paging_stats()
            if self.debug:
                self._check_invariants()
        self.stats["peak_active_slots"] = max(
            self.stats["peak_active_slots"], int(self.active.sum()))

        # decode_seconds times the segment alone. On the card the
        # admission work queued above may still be running, so the span
        # is read from CUDA events around the segment, which adds no host
        # sync; on the CPU every op has finished when it returns.
        on_card = self.device.type == "cuda"
        if on_card:
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))

        def attempt():
            # faults strike before the call, which has not touched the
            # cache yet, so a retried segment replays the same work; only
            # the attempt that runs records events
            if self.fault_injector is not None:
                self.fault_injector.check(self.stats["segments"],
                                          ("segment",))
            if on_card:
                ev0.record()
            t0 = time.perf_counter()
            out = self._segment_fn(self.params, self.cache, self.tok)
            if on_card:
                ev1.record()
            return out, t0

        (toks, self.cache, self.tok), t0 = retry_call(
            attempt, policy=self.retry_policy, retry_on=(TransientFault,),
            rng=self._retry_rng, sleep=self._sleep,
            on_retry=lambda *_: self.stats.__setitem__(
                "retries", self.stats["retries"] + 1))
        toks = toks.cpu().numpy()            # the segment's one host sync
        dt = (ev0.elapsed_time(ev1) / 1e3 if on_card
              else time.perf_counter() - t0)
        self.stats["decode_seconds"] += dt
        self._seg_ewma = (dt if self._seg_ewma == 0.0
                          else 0.2 * dt + 0.8 * self._seg_ewma)
        self.stats["segments"] += 1
        self.stats["wasted_slot_steps"] += int(
            (~self.active).sum()) * self.segment
        for slot in range(self.n_slots):
            if not self.active[slot]:
                continue
            if self.paged:
                self._index_np[slot] += self.segment
            take = int(min(self.segment, self.remaining[slot]))
            self.outputs[self.slot_rid[slot]].extend(
                int(t) for t in toks[slot, :take])
            self.remaining[slot] -= take
            self.stats["wasted_slot_steps"] += self.segment - take
            if self.remaining[slot] == 0:
                dl = self.slot_deadline[slot]
                if dl is not None and self._clock() > dl:
                    # completed and delivered, but late
                    self.stats["deadline_miss"] += 1
                self._free_slot(slot)

    def _free_slot_pages(self, slot: int) -> None:
        """Reclaim a freed slot's pages and reservation. A page returns to
        the free list only at refcount 0; the block-table row is cleared
        to -1 at once (pushed before the next segment), so the idle
        slot's continued writes land in the scratch page."""
        npg = int(self._slot_npages[slot])
        for p in self._pages_np[slot, :npg]:
            p = int(p)
            self._page_refs[p] -= 1
            if self._page_refs[p] == 0:
                self._free_pages.append(p)
        self._pages_np[slot, :] = -1
        self._slot_npages[slot] = 0
        self._committed -= (int(self._slot_reserve[slot])
                            - int(self._slot_unique[slot]))
        self._slot_reserve[slot] = 0
        self._slot_unique[slot] = 0
        self._index_np[slot] = 0
        if self.prefix_share:
            self._trim_trie()

    def _trim_trie(self) -> None:
        """LRU-trim cached prefixes down to the ``retain_pages``
        watermark."""
        while self._trie.evictable_pages(self._page_refs) > self.retain_pages:
            page = self._trie.evict_lru(self._page_refs)
            if page is None:
                break
            self._page_refs[page] -= 1
            self._free_pages.append(page)
            self.stats["prefix_evictions"] += 1

    def _check_invariants(self) -> None:
        """Debug-mode audit of the paging state: refcounts, free list and
        credit."""
        refs = self._page_refs
        mapped = 0
        for slot in range(self.n_slots):
            npg = int(self._slot_npages[slot])
            row = self._pages_np[slot]
            assert (row[npg:] == -1).all(), \
                f"slot {slot}: mapped entries past npages"
            assert (row[:npg] >= 0).all(), \
                f"slot {slot}: -1 sentinel read inside mapped range"
            mapped += npg
            if self.active[slot]:
                need = -(-(int(self._index_np[slot]) + self.segment)
                         // self.page_size)
                assert npg >= need, f"slot {slot}: segment pages unmapped"
                for p in row[:npg]:
                    assert refs[int(p)] >= 1, f"slot {slot}: freed page {p}"
        trie_pages = self._trie.page_count() if self.prefix_share else 0
        assert int(refs.sum()) == mapped + trie_pages, \
            "refcounts out of sync with block tables + trie"
        assert len(set(self._free_pages)) == len(self._free_pages), \
            "duplicate page on free list"
        for p in self._free_pages:
            assert refs[p] == 0, f"page {p} both free and referenced"
        assert (refs >= 0).all(), "negative refcount"
        assert len(self._free_pages) + int((refs > 0).sum()) == self.n_pages, \
            "page leak: free + referenced != total"
        assert self._committed == int(
            (self._slot_reserve - self._slot_unique).sum()) >= 0, \
            "reservation credit out of sync"

    def run(self) -> Dict[int, List[int]]:
        """Drain the queue and all active slots; returns {rid: tokens}."""
        while self.queue or self.active.any():
            self.step_segment()
        return self.outputs


# ---------------------------------------------------------------------- #
def _is_pool(key: str) -> bool:
    """Whether the cache leaf at flat key ``key`` ("k", "shared/v", ...)
    is K/V, which the paged layout keeps in pools."""
    return key.rsplit("/", 1)[-1] in ("k", "v")


def _pools(units):
    """(flat key, leaf) of every K/V leaf of a cache's unit tree."""
    return [(k, t) for k, t in flatten(units).items() if _is_pool(k)]


def _scatter_slot_leaf(dst: torch.Tensor, src: torch.Tensor, slot: int
                       ) -> None:
    """In place: write a batch-1 cache leaf into slot ``slot`` of a
    batch-``n_slots`` leaf. The slot axis differs by leaf ((U, B, ...)
    for K/V, (U, u, B, ...) for the hybrid's stacked Mamba2 layers), so
    it is the one axis where the shapes differ; with ``n_slots == 1``
    none does and the leaf is replaced."""
    ax = next((i for i, (a, b) in enumerate(zip(dst.shape, src.shape))
               if a != b), None)
    if ax is None:
        dst.copy_(src)
    else:
        dst.select(ax, slot).copy_(src.select(ax, 0))


def _scatter_slot(dst_tree, src_tree, slot: int) -> None:
    """Tree-wide ``_scatter_slot_leaf``."""
    srcs = flatten(src_tree)
    for key, dst in flatten(dst_tree).items():
        _scatter_slot_leaf(dst, srcs[key], slot)
