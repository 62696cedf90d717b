"""Production and smoke meshes (the reference's ``launch/mesh.py``), as
``torch.distributed`` ``DeviceMesh``es over the process group that is
running. Neither function starts a group: ``launch.train
--distributed`` takes ``torchrun``'s or starts a world of one, the
dry-run a fake group of 256 or 512 ranks.

One pod: 256 devices as ('data'=16, 'model'=16). Two pods: 512 as
('pod'=2, 'data'=16, 'model'=16); 'pod' extends data parallelism and
stays outermost.

The roofline constants are an NVIDIA H100 SXM's (the card the port runs
on: "NVIDIA H100 80GB HBM3, 700.00 W" as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives it). A 16-wide
'model' axis spans two 8-GPU NVLink domains, so the collective term,
taken at the NVLink rate, is a lower bound.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, HBM3 rate
PEAK_FLOPS_BF16 = 989e12        # FLOP/s a card
HBM_BW = 3.35e12                # bytes/s a card
# NVLink 4: 900 GB/s a card both ways together, 450e9 a direction
NVLINK_BW = 450e9               # bytes/s a card, one direction
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def hbm_capacity(device: int = 0) -> int:
    """The card's memory as ``torch.cuda.get_device_properties`` reads it
    (bytes); needs the card."""
    import torch
    return int(torch.cuda.get_device_properties(device).total_memory)


def _device_type() -> str:
    import torch.distributed as dist
    backend = str(dist.get_backend()).lower()
    return "cuda" if "nccl" in backend else "cpu"


def _mesh(shape, names, device_type=None):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group is running: start one "
                           "(torchrun, or launch.train --distributed) "
                           "before building a mesh")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {shape} needs {n} ranks, the group has "
                         f"{dist.get_world_size()}")
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_smoke_mesh(n_devices: int = 0, device_type=None):
    """A (data, model) mesh over the running group's ranks (1 rank ->
    (1, 1); 4 -> (2, 2); 8 -> (4, 2))."""
    import torch.distributed as dist
    n = n_devices or dist.get_world_size()
    data = max(1, n // 2)
    model = n // data
    return _mesh((data, model), ("data", "model"), device_type)
