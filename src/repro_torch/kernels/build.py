"""Build and load the CUDA kernels: ``nvcc`` into a shared library with a
plain C interface, loaded with ``ctypes``.

The library is built at first use from the sources under ``csrc/`` into
``_build/`` beside them (listed in ``.gitignore``), named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing is built or imported when this module is
imported: the CPU tests import every module and have no ``nvcc``.
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
# each library: its sources under csrc/ and the argtypes of its C entry
# points (pointers and the stream as c_void_p)
LIBRARIES = {
    "flash_attention": (["flash_attention.cu"], {
        "repro_flash_fwd": [_P] * 5 + [_I] * 8 + [_F, _P],
        "repro_flash_bwd_dq": [_P] * 7 + [_I] * 7 + [_F, _P],
        "repro_flash_bwd_dkdv": [_P] * 8 + [_I] * 7 + [_F, _P],
    }),
    "flash_decode": (["flash_decode.cu"], {
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


def _compile(name: str, sources, out: str) -> Dict[str, object]:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(f"nvcc failed for {name} "
                             f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)       # atomic: a reader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    with open(out + ".log", "w") as f:
        f.write(proc.stderr)
    return {"seconds": time.perf_counter() - t0, "log": proc.stderr}


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
        if not os.path.exists(self.path):
            info = _compile(name, sources, self.path)
            self.build_seconds = info["seconds"]
            self.build_log = info["log"]
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
    """Build every library at once: one ``nvcc`` per source, all started
    together (``subprocess`` releases the GIL while each compiles)."""
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

