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
import time
from typing import Dict, Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of each C entry point (pointers and the stream as c_void_p)
SIGNATURES = {
    "repro_flash_fwd": [_P] * 5 + [_I] * 6 + [_F, _P],
    "repro_flash_bwd_dq": [_P] * 7 + [_I] * 6 + [_F, _P],
    "repro_flash_bwd_dkdv": [_P] * 8 + [_I] * 6 + [_F, _P],
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


_FLASH: Optional[Library] = None


def flash_attention_library() -> Library:
    """The flash-attention library, built on first call."""
    global _FLASH
    if _FLASH is None:
        _FLASH = Library("flash_attention",
                         [os.path.join(CSRC, "flash_attention.cu")],
                         SIGNATURES)
    return _FLASH
