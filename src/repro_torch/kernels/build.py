"""Build and load the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

A library may span several sources: each ``.cu`` is compiled to an object
by its own ``nvcc -c``, all of them at once, and the objects are linked
once with ``-shared``; a ``.cuh`` header among the sources is compiled
only where a ``.cu`` includes it. The library is built at first use from
the sources under ``csrc/`` into ``_build/`` beside them (listed in
``.gitignore``), named by a hash of the flags and of every source, headers
included, so an edited source is rebuilt and an unchanged one is loaded
as it is. Nothing is built or imported when this module is imported: the
CPU tests import every module and have no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# flash decode's kernels, the longest compile (61 s as one source on an
# H100 machine's 8-CPU host), are split over a header, the C entries'
# source and one source per (dtype, head_dim) that instantiates its
# kernels (``csrc/flash_decode.cuh``), so that nvcc compiles them side by
# side
DECODE_SOURCES = ["flash_decode.cuh", "flash_decode.cu"] + [
    f"flash_decode_{t}_{d}.cu" for t in ("f32", "bf16")
    for d in (64, 112, 128, 160)]
# each library: its sources under csrc/ and the argtypes of its C entry
# points (pointers and the stream as c_void_p)
LIBRARIES = {
    "flash_attention": (["flash_attention.cu"], {
        "repro_flash_fwd": [_P] * 5 + [_I] * 8 + [_F, _P],
        "repro_flash_bwd_dq": [_P] * 7 + [_I] * 7 + [_F, _P],
        "repro_flash_bwd_dkdv": [_P] * 8 + [_I] * 7 + [_F, _P],
    }),
    "flash_decode": (DECODE_SOURCES, {
        "repro_flash_decode_workspace": [_I] * 5,
        "repro_flash_decode": [_P] * 6 + [_I] * 7 + [_F, _P],
        "repro_flash_decode_paged": [_P] * 7 + [_I] * 8 + [_F, _P],
    }),
    "ssd": (["ssd.cu"], {
        "repro_ssd_fwd_state": [_P] * 7 + [_I] * 6 + [_P],
        "repro_ssd_fwd_chunk": [_P] * 7 + [_I] * 6 + [_P],
        "repro_ssd_bwd_state": [_P] * 5 + [_I] * 6 + [_P],
        "repro_ssd_bwd_chunk": [_P] * 13 + [_I] * 6 + [_P],
    }),
}


class BuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise BuildError("nvcc not found: the CUDA kernels need the CUDA "
                     "toolkit on PATH or under /usr/local/cuda")


def compile_plan(nvcc: str, sources, obj_dir: str, out: str):
    """The commands that build ``out`` from ``sources``: (one ``nvcc -c``
    per ``.cu``, each with ``NVCC_FLAGS`` but ``-shared``, into
    ``obj_dir``; the one ``nvcc -shared`` that links their objects)."""
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    compiles, objects = [], []
    for i, src in enumerate(s for s in sources if s.endswith(".cu")):
        obj = os.path.join(obj_dir, f"{i}_{os.path.basename(src)[:-3]}.o")
        compiles.append([nvcc, *flags, "-c", "-o", obj, src])
        objects.append(obj)
    return compiles, [nvcc, *NVCC_FLAGS, "-o", out, *objects]


def _run_all(name: str, cmds):
    """Every command of ``cmds`` at once; (their stderr in ``cmds``' order,
    where ``-Xptxas -v`` writes each kernel's registers; each one's
    seconds)."""
    def run(cmd):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        return proc, time.perf_counter() - t0

    with ThreadPoolExecutor(len(cmds)) as pool:
        done = list(pool.map(run, cmds))
    failed = [f"{' '.join(p.args)} (exit {p.returncode}):\n{p.stderr}"
              for p, _ in done if p.returncode != 0]
    if failed:
        raise BuildError(f"nvcc failed for {name}: " + "\n".join(failed))
    return "".join(p.stderr for p, _ in done), [t for _, t in done]


def _compile(name: str, sources, out: str) -> Dict[str, object]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    obj_dir = tempfile.mkdtemp(dir=BUILD_DIR, prefix=f"{name}_obj_")
    tmp = os.path.join(obj_dir, os.path.basename(out))
    compiles, link = compile_plan(_nvcc(), sources, obj_dir, tmp)
    t0 = time.perf_counter()
    try:
        log, seconds = _run_all(name, compiles)
        link_log, (link_s,) = _run_all(name, [link])
        os.replace(tmp, out)       # atomic: a reader never sees half a file
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
    log += link_log
    with open(out + ".log", "w") as f:
        f.write(log)
    return {"seconds": time.perf_counter() - t0, "log": log,
            "steps": {**{os.path.basename(c[-1]): s
                         for c, s in zip(compiles, seconds)},
                      "link": link_s}}


class Library:
    """One built shared library and its typed C entry points."""

    def __init__(self, name: str, sources, signatures):
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for src in sources:
            with open(src, "rb") as f:
                digest.update(f.read())
        self.path = os.path.join(BUILD_DIR,
                                 f"lib{name}_{digest.hexdigest()[:12]}.so")
        self.build_seconds = 0.0
        self.build_log = ""
        self.build_steps = {}      # seconds of each source's nvcc, the link
        if not os.path.exists(self.path):
            info = _compile(name, sources, self.path)
            self.build_seconds = info["seconds"]
            self.build_log = info["log"]
            self.build_steps = info["steps"]
        self.lib = ctypes.CDLL(self.path)
        for fn, argtypes in signatures.items():
            f = getattr(self.lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int


_LOADED: Dict[str, Library] = {}
_LOCK = threading.Lock()


def library(name: str) -> Library:
    """The library ``name`` of ``LIBRARIES``, built on first call."""
    lib = _LOADED.get(name)
    if lib is None:
        sources, signatures = LIBRARIES[name]
        lib = Library(name, [os.path.join(CSRC, s) for s in sources],
                      signatures)
        with _LOCK:
            lib = _LOADED.setdefault(name, lib)
    return lib


def build_all() -> Dict[str, Library]:
    """Build every library at once: one ``nvcc -c`` per source of every
    library, all started together (``subprocess`` releases the GIL while
    each compiles), then each library's link."""
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        return dict(zip(LIBRARIES, pool.map(library, LIBRARIES)))


def launch(name: str, entry: str, *args) -> None:
    """Call C entry ``entry`` of library ``name`` on the current stream;
    raise if the launch failed."""
    import torch
    fn = getattr(library(name).lib, entry)
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} failed to launch: CUDA error {rc}")

