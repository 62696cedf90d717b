"""Deterministic fault injection for the simulator (the port's copy of
the reference's ``core/faults.py``).

* **Per-server MTBF**: each server draws an independent sequence of
  Weibull lifetimes (``weibull_shape=1`` is exponential), mean-normalized
  so the configured MTBF is the distribution mean. A failed server is
  down for ``server_repair`` seconds, then recovers;
  ``correlated_servers > 1`` kills that many rack neighbours at once.
* **Per-job failure rate**: each job draws a Poisson process of crash
  times (mean inter-arrival ``job_mtbf``); a crash only takes effect if
  the job is RUNNING at that instant.

The whole timeline is precomputed from the seed alone, before the
simulation starts, and a model with both rates at zero yields an empty
timeline: the run is then the same as one with no fault model.
Recovery (in :mod:`core.engine`): a failed job re-queues with its
progress rounded down to the last checkpoint; a failed server kills
every job on its GPUs; surviving sharing peers are restored to the
largest sub-batch that fits (``rescale_peers``).

RNG streams are seeded with strings (``"{seed}/server/{sid}"``), which
``random.Random`` hashes via SHA-512: stable across processes and
Python versions, unlike ``hash()``.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import List, Sequence, Tuple

__all__ = ["FaultEvent", "FaultModel"]

# (time, seq, kind, target) — kind is one of "fail_job" (target jid),
# "fail_server" / "recover_server" (target server id)
FaultEvent = Tuple[float, int, str, int]


@dataclass(frozen=True)
class FaultModel:
    """Seeded failure-process parameters. All rates default to 0 —
    a default-constructed model injects nothing."""

    seed: int = 0
    job_mtbf: float = 0.0          # mean s between crash draws per job; 0 off
    server_mtbf: float = 0.0       # mean lifetime per server (s); 0 off
    server_repair: float = 600.0   # downtime before a server recovers (s)
    weibull_shape: float = 1.0     # server lifetime shape; 1 = exponential
    correlated_servers: int = 1    # servers killed together per failure
    checkpoint_interval: float = 0.0   # iterations between checkpoints
    horizon: float = 30 * 24 * 3600.0  # stop sampling past this time
    rescale_peers: bool = True     # reconfig surviving co-tenants
    max_events_per_source: int = 10_000

    def __post_init__(self) -> None:
        if self.job_mtbf < 0 or self.server_mtbf < 0:
            raise ValueError("MTBF values must be >= 0")
        if self.server_repair <= 0:
            raise ValueError("server_repair must be > 0")
        if self.weibull_shape <= 0:
            raise ValueError("weibull_shape must be > 0")
        if self.correlated_servers < 1:
            raise ValueError("correlated_servers must be >= 1")
        if self.checkpoint_interval < 0:
            raise ValueError("checkpoint_interval must be >= 0")

    # ------------------------------------------------------------------ #
    @property
    def enabled(self) -> bool:
        return self.job_mtbf > 0 or self.server_mtbf > 0

    def timeline(self, n_servers: int, jids: Sequence[int]
                 ) -> List[FaultEvent]:
        """The full, sorted fault-event timeline for a cluster of
        ``n_servers`` and the given job ids. Pure in (model, inputs)."""
        events: List[Tuple[float, str, int]] = []
        if self.server_mtbf > 0 and n_servers > 0:
            # mean-normalize the Weibull so E[lifetime] == server_mtbf
            scale = self.server_mtbf / math.gamma(
                1.0 + 1.0 / self.weibull_shape)
            for sid in range(n_servers):
                rng = random.Random(f"{self.seed}/server/{sid}")
                t = 0.0
                for _ in range(self.max_events_per_source):
                    t += rng.weibullvariate(scale, self.weibull_shape)
                    if t >= self.horizon:
                        break
                    for i in range(self.correlated_servers):
                        target = (sid + i) % n_servers
                        events.append((t, "fail_server", target))
                        events.append((t + self.server_repair,
                                       "recover_server", target))
                    t += self.server_repair
        if self.job_mtbf > 0:
            for jid in jids:
                rng = random.Random(f"{self.seed}/job/{jid}")
                t = 0.0
                for _ in range(self.max_events_per_source):
                    t += rng.expovariate(1.0 / self.job_mtbf)
                    if t >= self.horizon:
                        break
                    events.append((t, "fail_job", int(jid)))
        events.sort()   # (time, kind, target): total, deterministic order
        return [(t, seq, kind, target)
                for seq, (t, kind, target) in enumerate(events)]

    def truncate_progress(self, iters_done: float) -> float:
        """Progress surviving a failure: rounded down to the last
        checkpoint boundary (with a tiny relative epsilon so engines
        that accrued the same progress modulo float noise land on the
        same checkpoint). No checkpointing → the attempt restarts from
        zero."""
        ck = self.checkpoint_interval
        if ck <= 0:
            return 0.0
        kept = math.floor(iters_done / ck + 1e-9) * ck
        return min(kept, iters_done)
