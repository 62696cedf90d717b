"""Fleet agent: one emulated server process (the reference's
``launch/agent.py``).

Runs as ``python -m repro_torch.launch.agent --host H --port P --id aN
[--device cpu] [--threads N]``, on the card unless ``--device cpu`` is
given. Connects to the master, sends a hello, then loops on lease
commands. Each lease is executed with a fresh :class:`ScheduleExecutor`,
restoring every member from its best valid-epoch checkpoint, stepping the
group round-robin in the same ``sorted(names)`` order the single-host
executor uses (which is what makes fleet runs bit-comparable to
single-host runs: each member's parameters and batch are re-derived from
its seed, then overwritten by the checkpoint), and finally checkpointing
all members and draining the async writer *before* the result message
goes out (no exit with queued writes). Each lease also prints one JSON
line to the agent's output (the master's ``<ckpt_dir>/<id>.log``): its
seconds, its group steps' walltime, the device's peak memory and the
kernel launches it made. The lease names the autotuning table to route
by (the master's, or none), and the agent installs it before it steps.

The reference keeps one compiled-program cache across an agent's leases
(``program_cache``); the port runs eagerly and compiles nothing, so there
is nothing to share and the agent has no such cache. ``--threads`` sets
torch's intra-op threads, so a CPU agent can sum in the same order as the
process it is compared with.

A heartbeat thread reports ``{job: steps_done}`` progress watermarks on
a fixed interval, tagged with the current lease epoch so the master can
fence messages from a lease it has already revoked. The reporter and
the heartbeat share one send lock; frames never interleave.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import socket
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointError, checkpoint_crc
from repro_torch.kernels import autotune, flash_attention, flash_decode, ssd
from repro_torch.launch.cluster import ScheduleExecutor
from repro_torch.launch.wire import (MessageReader, WireError, send_msg,
                                     spec_from_wire)

__all__ = ["AgentRuntime", "agent_main"]


class _LeaseCancelled(Exception):
    pass


def _best_checkpoints(ckpt_dir: str, name: str,
                      epochs: List[int]) -> List[Tuple[int, int, str]]:
    """Candidate restore files for ``name``, best first: highest step,
    then highest epoch. Unreadable files are skipped here; corrupt-but-
    parseable ones are caught by the CRC check at restore time. A write
    cut by a SIGKILL never sits under this name: the checkpoint layer
    writes a temporary file and renames it into place when complete."""
    cands = []
    for e in epochs:
        path = os.path.join(ckpt_dir, f"{name}.e{int(e):04d}.npz")
        if not os.path.exists(path):
            continue
        try:
            with np.load(path) as data:
                step = int(data["step"])
        except Exception:
            continue
        cands.append((step, int(e), path))
    return sorted(cands, reverse=True)


class AgentRuntime:
    """One agent process: reader thread feeding a command loop, plus a
    heartbeat thread. Leases execute on the main thread."""

    def __init__(self, sock: socket.socket, agent_id: str,
                 heartbeat_interval: float = 0.25, device=None) -> None:
        self.sock = sock
        self.id = agent_id
        self.heartbeat_interval = heartbeat_interval
        self.device = device
        self.send_lock = threading.Lock()
        self._wm_lock = threading.Lock()
        self.watermark: Dict[str, int] = {}
        self.epoch: Optional[int] = None
        self._cancelled: set = set()
        self._stop = threading.Event()
        self._queue: "List[Optional[Dict[str, Any]]]" = []
        self._queue_cond = threading.Condition()
        self.leases_run = 0

    # -- threads ------------------------------------------------------- #
    def _reader_loop(self) -> None:
        reader = MessageReader(self.sock)
        while True:
            try:
                msg = reader.read()
            except WireError:
                msg = None
            if msg is not None and msg.get("type") == "cancel":
                # out-of-band: the main thread may be inside a lease
                self._cancelled.add(msg.get("lease_id"))
                continue
            with self._queue_cond:
                self._queue.append(msg)
                self._queue_cond.notify()
            if msg is None:
                return

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            with self._wm_lock:
                wm = dict(self.watermark)
                epoch = self.epoch
            try:
                send_msg(self.sock, {"type": "heartbeat", "agent": self.id,
                                     "watermark": wm, "epoch": epoch},
                         self.send_lock)
            except WireError:
                return      # master gone; main loop sees EOF and exits

    # -- main loop ----------------------------------------------------- #
    def run(self) -> None:
        send_msg(self.sock, {"type": "hello", "role": "agent",
                             "id": self.id, "pid": os.getpid()},
                 self.send_lock)
        for target in (self._reader_loop, self._heartbeat_loop):
            threading.Thread(target=target, daemon=True).start()
        try:
            while True:
                with self._queue_cond:
                    while not self._queue:
                        self._queue_cond.wait()
                    msg = self._queue.pop(0)
                if msg is None or msg.get("type") == "shutdown":
                    return
                if msg.get("type") == "lease":
                    self._run_lease(msg)
        finally:
            self._stop.set()
            try:
                self.sock.close()
            except OSError:
                pass

    # -- lease execution ----------------------------------------------- #
    def _run_lease(self, msg: Dict[str, Any]) -> None:
        lease_id, epoch = msg["lease_id"], int(msg["epoch"])
        try:
            report, walltime = self._execute_lease(msg)
        except Exception as exc:   # noqa: BLE001 — reported, not hidden
            with self._wm_lock:
                self.epoch = None
            try:
                send_msg(self.sock,
                         {"type": "lease_error", "lease_id": lease_id,
                          "epoch": epoch,
                          "error": f"{type(exc).__name__}: {exc}"},
                         self.send_lock)
            except WireError:
                pass
            return
        with self._wm_lock:
            self.epoch = None
        try:
            send_msg(self.sock,
                     {"type": "lease_done", "lease_id": lease_id,
                      "epoch": epoch, "walltime": walltime,
                      "report": report},
                     self.send_lock)
        except WireError:
            pass

    def _execute_lease(self, msg: Dict[str, Any]
                       ) -> Tuple[Dict[str, Dict[str, Any]], float]:
        lease_id, epoch = msg["lease_id"], int(msg["epoch"])
        ckpt_dir = msg["ckpt_dir"]
        step_sleep = float(msg.get("step_sleep", 0.0))
        tag = f".e{epoch:04d}"
        self.leases_run += 1
        with self._wm_lock:
            self.epoch = epoch
            self.watermark = {}
        t0 = time.perf_counter()
        table = msg.get("autotune")
        autotune.set_table(None if table is None
                           else autotune.AutotuneTable(table))
        for mod in (flash_attention, flash_decode, ssd):
            mod.reset_launches()
        on_card = self.device is None or torch.device(
            self.device).type == "cuda"
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        with ScheduleExecutor(
                device=self.device, checkpoint_dir=ckpt_dir,
                checkpoint_every=int(msg.get("checkpoint_every", 0)),
                checkpoint_tag=tag) as ex:
            left: Dict[str, int] = {}
            resumed: Dict[str, int] = {}
            for m in msg["members"]:
                name = m["name"]
                ex.submit(name, spec_from_wire(m["spec"]),
                          int(m["total_steps"]))
                ex.start(name, sub_batch=m.get("sub_batch"))
                self._restore_member(ex, name, ckpt_dir,
                                     m.get("restore_epochs") or [])
                steps = ex.runs[name].steps_done
                resumed[name] = steps
                with self._wm_lock:
                    self.watermark[name] = steps
                if steps < int(m["end_step"]):
                    left[name] = int(m["end_step"])
            walltime = 0.0
            while left:
                if lease_id in self._cancelled:
                    raise _LeaseCancelled(f"lease {lease_id} cancelled")
                names = sorted(left)
                res = ex.step_group(names)
                if "dropped" in res:
                    raise RuntimeError(
                        f"member {res['dropped']!r} dropped mid-lease")
                walltime += res["walltime"]
                with self._wm_lock:
                    for n in names:
                        self.watermark[n] = ex.runs[n].steps_done
                for n in names:
                    if ex.runs[n].steps_done >= left[n]:
                        del left[n]
                if step_sleep:
                    time.sleep(step_sleep)
            paths = {m["name"]: ex.checkpoint(m["name"])
                     for m in msg["members"]}
            report: Dict[str, Dict[str, Any]] = {}
            for m in msg["members"]:
                name = m["name"]
                run = ex.runs[name]
                loss = (run.last_metrics or {}).get("loss")
                report[name] = {
                    "steps": run.steps_done,
                    "resumed_from": resumed[name],
                    "loss": None if loss is None else float(loss),
                    "ckpt": os.path.basename(paths[name]),
                }
        # executor closed: every write has landed; CRCs are readable
        for name, rep in report.items():
            rep["crc"] = checkpoint_crc(
                os.path.join(ckpt_dir, rep["ckpt"]))
        print(json.dumps({
            "agent": self.id, "lease": lease_id, "epoch": epoch,
            "members": sorted(report), "seconds": time.perf_counter() - t0,
            "walltime": walltime,
            "peak_bytes": torch.cuda.max_memory_allocated() if on_card
            else None,
            "launches": {**flash_attention.LAUNCHES, **flash_decode.LAUNCHES,
                         **ssd.LAUNCHES}}), flush=True)
        return report, walltime

    def _restore_member(self, ex: ScheduleExecutor, name: str,
                        ckpt_dir: str, epochs: List[int]) -> None:
        """Restore from the best valid-epoch checkpoint, falling back to
        the next-best on CRC failure (the content CRC is what makes
        reading a possibly-mid-crash file safe) and to seeded-init step 0
        when no usable file exists."""
        for _step, _epoch, path in _best_checkpoints(ckpt_dir, name,
                                                     epochs):
            try:
                ex.restore_run(name, path)
                return
            except (CheckpointError, FileNotFoundError, ValueError):
                continue


def agent_main(host: str, port: int, agent_id: str,
               heartbeat_interval: float = 0.25, device=None) -> None:
    sock = socket.create_connection((host, port))
    AgentRuntime(sock, agent_id, heartbeat_interval=heartbeat_interval,
                 device=device).run()


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="repro_torch fleet agent")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--id", default=f"a{os.getpid()}")
    ap.add_argument("--heartbeat", type=float, default=0.25)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--threads", type=int, default=None,
                    help="torch intra-op threads (default: torch's)")
    args = ap.parse_args(argv)
    if args.threads is not None:
        torch.set_num_threads(args.threads)
    # torch.utils.checkpoint (the models' remat) imports torch._dynamo at
    # its first call: seconds in a fresh process, paid here, before the
    # hello, instead of inside the first lease
    importlib.import_module("torch._dynamo")
    agent_main(args.host, args.port, args.id,
               heartbeat_interval=args.heartbeat, device=args.device)


if __name__ == "__main__":
    main()
