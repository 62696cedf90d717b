"""The benchmark's one door into the system under test, the PyTorch/CUDA
port (``src/repro_torch``): its configurations, its parameter layout, its
optimizer's settings and its schedule executor. Nothing else of the
benchmark imports the port, and nothing here imports ``jax`` or ``repro``.
"""
from __future__ import annotations

import dataclasses
import inspect


def port_config(run: dict):
    """The port's ``ArchConfig`` for a configuration file's ``run`` block:
    the port's config of ``run["arch"]`` with every field the block
    names set to the block's value. Refuses a block whose family is not
    the port's."""
    from repro_torch.configs import get_config
    base = get_config(run["arch"])
    names = {f.name for f in dataclasses.fields(base)}
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in run.items() if k in names}
    cfg = dataclasses.replace(base, **kw)
    if cfg.family != run["family"]:
        raise ValueError(f"{run['arch']}: the port's family is "
                         f"{cfg.family!r}, the file says {run['family']!r}")
    return cfg


def layout(cfg) -> dict:
    """{flat key: (shape, dtype)} of the port's parameters, from its
    initialisation on ``meta`` (shapes only, no values)."""
    from repro_torch.models import init_params
    out = {}

    def walk(tree, prefix):
        for key in sorted(tree):
            val = tree[key]
            if isinstance(val, dict):
                walk(val, f"{prefix}{key}/")
            else:
                out[f"{prefix}{key}"] = (tuple(val.shape), val.dtype)
    walk(init_params(cfg, device="meta"), "")
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = leaf
    return tree


def optimizer_settings() -> dict:
    """The learning rate, weight decay and Adam constants a job of the
    executor trains with (its ``TrainConfig`` defaults and
    ``adamw_update``'s)."""
    from repro_torch.train import TrainConfig, adamw_update
    tc = TrainConfig()
    sig = inspect.signature(adamw_update).parameters
    return {"lr": tc.lr, "weight_decay": tc.weight_decay,
            "b1": sig["b1"].default, "b2": sig["b2"].default,
            "eps": sig["eps"].default}


class Jobs:
    """The cell's jobs in one ``ScheduleExecutor``: each started with the
    benchmark's parameters, zeroed AdamW moments and first batch."""

    def __init__(self, device):
        from repro_torch.launch.cluster import ScheduleExecutor
        self.ex = ScheduleExecutor(device=device)
        self.names = []

    def start(self, name, cfg, *, batch: int, seq: int, sub_batch: int,
              params: dict, first_batch: dict, moments_dtype) -> None:
        import torch
        from repro_torch.launch.cluster import JobSpec
        from repro_torch.train import OptState
        tree = unflatten(params)
        zeros = {k: torch.zeros(t.shape, dtype=moments_dtype,
                                device=t.device) for k, t in params.items()}
        opt = OptState(step=0, m=unflatten(zeros),
                       v=unflatten({k: torch.zeros_like(t)
                                    for k, t in zeros.items()}))
        self.ex.submit(name, JobSpec(cfg, batch=batch, seq=seq),
                       steps=2 ** 62)
        self.ex.start(name, sub_batch=sub_batch,
                      state=(tree, opt, first_batch))
        self.names.append(name)

    def feed(self, name: str, batch: dict) -> None:
        """The batch the job's next step trains on."""
        self.ex.runs[name].batch = batch

    def step(self):
        """One group step of every job: (walltime s, {job: loss})."""
        res = self.ex.step_group(self.names)
        return res["walltime"], res["losses"]

    def accum_steps(self, name: str) -> int:
        return self.ex.runs[name].accum_steps

    def params(self, name: str) -> dict:
        return _flat(self.ex.runs[name].params)

    def first_moments(self, name: str) -> dict:
        return _flat(self.ex.runs[name].opt.m)

    def close(self) -> None:
        self.ex.close()
        for run in self.ex.runs.values():
            run.params = run.opt = run.batch = run.last_metrics = None
        self.ex = None


def _flat(tree, prefix: str = "") -> dict:
    out = {}
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.update(_flat(val, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = val
    return out
