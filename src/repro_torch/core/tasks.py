"""DL task profiles used by the workload generators (the port's copy of
the reference's ``core/tasks.py``, same arithmetic).

The paper drives its simulator with six Pollux tasks (BERT, CIFAR10,
DeepSpeech2, ImageNet, NCF, YoloV3) measured on 2080 Ti nodes. The raw
coefficients are not published; the profiles below are synthesized from
public model characteristics (params, per-sample train FLOPs, activation
footprints) so that Eq. 3/4/7 reproduce the qualitative throughput
structure of Fig. 2 (BERT compute/memory-bound, YoloV3 network-bound past
12 GPUs, NCF tiny, ...). :func:`profile_from_arch` turns one of the
repo's architectures into a profile of the same kind.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from .perf_model import (GPU_2080TI, HardwareSpec, PerfParams,
                         derive_perf_params)

__all__ = ["PAPER_TASK_PROFILES", "TaskProfile", "profile_from_arch"]


@dataclass(frozen=True)
class TaskProfile:
    name: str
    flops_per_sample: float      # fwd+bwd FLOPs per training sample
    param_bytes: float           # gradient message size (fp32 bytes)
    act_bytes_per_sample: float  # activation working set per sample
    default_batch: int           # per-GPU user batch
    opt_state_multiplier: float = 3.0  # adam: master + m + v over grads
    framework_bytes: float = 1.0 * 2**30
    delta: float = 2.0

    def perf_params(self, n_gpus: int,
                    hw: HardwareSpec = GPU_2080TI) -> PerfParams:
        opt = self.param_bytes * self.opt_state_multiplier
        return derive_perf_params(
            flops_per_sample=self.flops_per_sample,
            param_bytes=self.param_bytes,
            n_workers=n_gpus,
            hw=hw,
            act_bytes_per_sample=self.act_bytes_per_sample,
            opt_bytes=opt + self.framework_bytes,
            delta=self.delta,
        )


PAPER_TASK_PROFILES: Dict[str, TaskProfile] = {
    # name                  flops/sample  grad bytes  act/sample   batch
    "bert": TaskProfile("bert", 8.4e10, 440e6, 45e6, 32),
    "cifar10": TaskProfile("cifar10", 1.7e9, 45e6, 5e6, 128),
    "deepspeech2": TaskProfile("deepspeech2", 2.4e10, 350e6, 60e6, 32),
    "imagenet": TaskProfile("imagenet", 1.23e10, 102e6, 110e6, 64),
    "ncf": TaskProfile("ncf", 1.6e8, 120e6, 0.2e6, 1024),
    "yolov3": TaskProfile("yolov3", 1.96e11, 248e6, 380e6, 16),
}


def profile_from_arch(name: str, *, n_params: float, n_active_params: float,
                      seq_len: int, batch: int,
                      act_bytes_per_token: float) -> TaskProfile:
    """Build a TaskProfile for one of the repo's architectures: a job in
    the cluster trace is 'train <arch> at seq_len with per-device batch'."""
    return TaskProfile(
        name=name,
        flops_per_sample=6.0 * n_active_params * seq_len,
        param_bytes=4.0 * n_params,
        act_bytes_per_sample=act_bytes_per_token * seq_len,
        default_batch=batch,
        framework_bytes=0.5 * 2**30,
    )
