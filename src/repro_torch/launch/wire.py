"""Fleet wire protocol: newline-delimited JSON over a local socket (the
reference's ``launch/wire.py``; its frames and its ``JobSpec`` JSON are
byte for byte the reference's, so the two packages read each other).

The master/agent runtime emulates a multi-host cluster
as one process per server, talking over localhost TCP — deliberately the
thinnest transport that still exhibits real distributed failure modes
(half-open connections, SIGKILLed peers, late messages from fenced
zombies). Everything that crosses the wire is a small JSON dict; job
*state* never does — params/optimizer tensors travel through the shared
checkpoint directory (CRC-verified npz), as a multi-host deployment
would use a network filesystem or object store.

Also here: the :class:`JobSpec` <-> JSON codec. An ``ArchConfig`` is a
flat frozen dataclass of primitives, so it serializes losslessly; the
agent reconstructs the spec and re-derives params/opt/batch with the
same seeded initializers the single-host executor uses — which is what
makes cross-process runs bit-comparable.
"""
from __future__ import annotations

import dataclasses
import json
import socket
import threading
from typing import Any, Dict, Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.cluster import JobSpec

# fields whose JSON list form must round-trip back to tuples
_TUPLE_FIELDS = tuple(
    f.name for f in dataclasses.fields(ArchConfig)
    if "Tuple" in str(f.type) or isinstance(f.default, tuple))


class WireError(ConnectionError):
    """The peer went away (EOF / reset) or sent an unparseable frame."""


def spec_to_wire(spec: JobSpec) -> Dict[str, Any]:
    return {
        "cfg": dataclasses.asdict(spec.cfg),
        "batch": spec.batch,
        "accum_steps": spec.accum_steps,
        "seq": spec.seq,
        "seed": spec.seed,
    }


def spec_from_wire(d: Dict[str, Any]) -> JobSpec:
    cfg_dict = dict(d["cfg"])
    for name in _TUPLE_FIELDS:
        if name in cfg_dict and isinstance(cfg_dict[name], list):
            cfg_dict[name] = tuple(cfg_dict[name])
    return JobSpec(cfg=ArchConfig(**cfg_dict), batch=int(d["batch"]),
                   accum_steps=int(d["accum_steps"]), seq=int(d["seq"]),
                   seed=int(d["seed"]))


def send_msg(sock: socket.socket, msg: Dict[str, Any],
             lock: Optional[threading.Lock] = None) -> None:
    """One JSON frame. ``lock`` serializes writers that share a socket
    (an agent's heartbeat thread vs its lease reporter)."""
    data = (json.dumps(msg, separators=(",", ":")) + "\n").encode()
    try:
        if lock is not None:
            with lock:
                sock.sendall(data)
        else:
            sock.sendall(data)
    except OSError as exc:
        raise WireError(f"send failed: {exc}") from exc


class MessageReader:
    """Buffered frame reader for one socket. ``read()`` returns the next
    decoded message or ``None`` on a clean/abrupt EOF — a SIGKILLed
    peer's socket reads as EOF (or reset), never as a hang."""

    def __init__(self, sock: socket.socket) -> None:
        self._sock = sock
        self._buf = b""

    def read(self) -> Optional[Dict[str, Any]]:
        while b"\n" not in self._buf:
            try:
                chunk = self._sock.recv(65536)
            except OSError:
                return None
            if not chunk:
                return None
            self._buf += chunk
        line, self._buf = self._buf.split(b"\n", 1)
        if not line.strip():
            return self.read()
        try:
            return json.loads(line)
        except json.JSONDecodeError as exc:
            raise WireError(f"bad frame {line[:80]!r}: {exc}") from exc


def request(host: str, port: int, msg: Dict[str, Any],
            timeout: float = 10.0) -> Dict[str, Any]:
    """One-shot client RPC: connect, send a hello + the request, return
    the single JSON response (the CLI's transport)."""
    with socket.create_connection((host, port), timeout=timeout) as sock:
        send_msg(sock, {"type": "hello", "role": "client"})
        send_msg(sock, msg)
        reader = MessageReader(sock)
        resp = reader.read()
    if resp is None:
        raise WireError("master closed the connection without replying")
    return resp
