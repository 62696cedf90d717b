"""npz checkpoints in the reference's on-disk format (the reference's
``checkpoint/npz.py``): a tree is flattened to ``/``-joined key paths,
saved atomically (tmp file + fsync + rename) and restored into a
template of the same structure. A corrupted or truncated file raises
:class:`CheckpointError` with the path and the cause, never a raw
``zipfile`` traceback.

The key scheme is the reference's ``_flatten``: dict keys in sorted
order, a dataclass field as ``.name`` (JAX names a NamedTuple field
so), fields in declaration order. An executor state therefore has the keys
``opt/.step``, ``opt/.m/<param key>``, ``opt/.v/<param key>``,
``params/<param key>`` and ``step``; Python ints (both step leaves) are
written as ``int32`` scalars, as ``jnp.asarray`` makes them.

Every file carries the reference's CRC32 **content** checksum
(``__crc32__``): over the sorted keys, each key's dtype and shape tokens,
then the raw bytes. Bit-rot that still parses as an npz raises
:class:`CheckpointError` on load. The stored CRC doubles as a state
digest: equal trees give equal CRCs in either package.

bfloat16: numpy has none. A bf16 leaf is written as its raw 16 bits
under the member type ``<V2``, which is what ``np.savez`` writes for the
reference's bf16 arrays, and is hashed under the token ``"bfloat16"``,
as the reference hashes it when it saves. On load a 2-byte void member
is read back as bf16 bits under that same token. (The reference's own
loader hashes such a member as ``"|V2"`` and so refuses its own bf16
files; the port does not copy that.) Members are written without a
staging copy: the npy header, then the array's buffer.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import zipfile
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from numpy.lib import format as npy_format

__all__ = ["CheckpointError", "checkpoint_crc", "load_pytree", "restore",
           "save", "save_pytree"]

_CRC_KEY = "__crc32__"
_BF16_DESCR = "<V2"        # the npy type of a reference bf16 array


class CheckpointError(RuntimeError):
    """A checkpoint file is unreadable (corrupted, truncated, or not an
    npz archive). Carries ``path`` so recovery code can report which
    file is damaged."""

    def __init__(self, path: str, reason: str) -> None:
        self.path = path
        super().__init__(f"checkpoint {path!r} is unreadable: {reason}")


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.kind == "V" and arr.dtype.itemsize == 2


def _dtype_token(arr: np.ndarray) -> str:
    return "bfloat16" if _is_bf16(arr) else str(arr.dtype)


def _leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the reference's flatten order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        items = [("." + f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    else:
        return [(prefix[:-1], tree)]
    out = []
    for key, val in items:
        out += _leaves(val, f"{prefix}{key}/")
    return out


def _to_numpy(leaf) -> np.ndarray:
    """A leaf as numpy, sharing memory with a host tensor; a bf16 tensor
    becomes its raw bits as a 2-byte void array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _to_numpy(leaf) for key, leaf in _leaves(tree)}


def _raw(arr: np.ndarray) -> np.ndarray:
    """The C-order bytes of ``arr`` as a flat uint8 view (no copy for a
    contiguous array): what ``arr.tobytes()`` would return."""
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _content_crc(flat: Dict[str, np.ndarray]) -> int:
    """CRC32 over the flattened content in sorted-key order: each key,
    its dtype and shape tokens, and the raw array bytes. ``zlib.crc32``
    reads the buffer in place and releases the interpreter lock on large
    buffers, so a background writer does not stall a training step."""
    crc = 0
    for key in sorted(flat):
        # as the reference: ascontiguousarray makes a scalar (1,), and
        # the shape token is that of the result
        arr = np.ascontiguousarray(flat[key])
        for token in (key, _dtype_token(arr), str(arr.shape)):
            crc = zlib.crc32(token.encode(), crc)
        crc = zlib.crc32(_raw(arr), crc)
    return crc & 0xFFFFFFFF


def _write_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    """``np.savez``'s archive (stored, zip64 members named ``<key>.npy``
    in insertion order), each member a version-1.0 npy header and the
    array's bytes, with a bf16 leaf typed ``<V2``."""
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in flat.items():
            header = {"descr": (_BF16_DESCR if _is_bf16(arr)
                                else npy_format.dtype_to_descr(arr.dtype)),
                      "fortran_order": False, "shape": arr.shape}
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                npy_format.write_array_header_1_0(fid, header)
                fid.write(_raw(arr))


def save_pytree(path: str, tree) -> None:
    flat = _flatten(tree)
    flat[_CRC_KEY] = np.asarray(_content_crc(flat), dtype=np.uint32)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    try:
        _write_npz(tmp, flat)
        # fsync before rename: os.replace is atomic on the directory
        # entry, but a crash between write and flush could otherwise
        # publish a truncated file under the final name
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _read(path: str) -> Dict[str, np.ndarray]:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    except (zipfile.BadZipFile, ValueError, EOFError, OSError) as exc:
        raise CheckpointError(path, f"{type(exc).__name__}: {exc}") from exc


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr).reshape(arr.shape)
    if _is_bf16(arr):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _rebuild(like, values: Dict[str, Any], prefix: str = ""):
    """``like``'s structure with each leaf taken from ``values``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, values, f"{prefix}{k}/")
                for k, v in like.items()}
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), values,
                             f"{prefix}.{f.name}/")
            for f in dataclasses.fields(like)})
    return values[prefix[:-1]]


@torch.no_grad()
def load_pytree(path: str, like) -> Any:
    """Restore into the structure of ``like`` (a template tree).

    The template's tensors are overwritten **in place** (``copy_``, cast
    to each tensor's dtype, on its device), so a restore on the card
    holds one copy of the state; the returned tree holds those same
    tensors, and Python numbers for the template's numbers. Every key and
    shape is checked before any tensor is written.

    Raises :class:`FileNotFoundError` if ``path`` does not exist and
    :class:`CheckpointError` if it exists but cannot be parsed.
    """
    flat = _read(path)
    stored = flat.pop(_CRC_KEY, None)
    if stored is not None:
        stored_crc = int(stored)
        computed = _content_crc(flat)
        if computed != stored_crc:
            raise CheckpointError(
                path, f"content CRC mismatch: stored {stored_crc:#010x}, "
                      f"computed {computed:#010x} (silent bit-rot)")
    leaves = _leaves(like)
    for key, leaf in leaves:
        if key not in flat:
            raise KeyError(f"checkpoint missing {key!r}")
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
        if tuple(flat[key].shape) != shape:
            raise ValueError(f"{key}: shape {flat[key].shape} != {shape}")
    values = {}
    for key, leaf in leaves:
        arr = flat[key]
        if isinstance(leaf, torch.Tensor):
            values[key] = leaf.copy_(_to_tensor(arr))
        else:
            values[key] = type(leaf)(arr.item())
    return _rebuild(like, values)


def checkpoint_crc(path: str) -> Optional[int]:
    """The stored content CRC of a checkpoint file (``None`` for files
    written before the checksum existed). Reads one tiny npz member."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        with np.load(path) as data:
            if _CRC_KEY not in data.files:
                return None
            return int(data[_CRC_KEY])
    except (zipfile.BadZipFile, ValueError, EOFError, OSError) as exc:
        raise CheckpointError(path, f"{type(exc).__name__}: {exc}") from exc


def save(path: str, *, params, opt_state=None, step: int = 0) -> None:
    tree = {"params": params, "step": int(step)}
    if opt_state is not None:
        tree["opt"] = opt_state
    save_pytree(path, tree)


def restore(path: str, *, params_like, opt_like=None) -> Tuple:
    """(params, opt, step), restored in place into ``params_like`` and
    ``opt_like``."""
    like = {"params": params_like, "step": 0}
    if opt_like is not None:
        like["opt"] = opt_like
    tree = load_pytree(path, like)
    return tree["params"], tree.get("opt"), int(tree["step"])
