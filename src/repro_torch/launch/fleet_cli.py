"""``repro-torch-fleet``: mgpu_server-shaped CLI for the port's fleet
runtime (the twin of the reference's ``repro-fleet``). Run as
``python -m repro_torch.launch.fleet_cli`` or ``repro-torch-fleet``.

Subcommands::

    repro-torch-fleet serve  --agents 2 --ckpt-dir DIR [--port-file F]
                             [--device cpu]
    repro-torch-fleet submit --port P --arch minicpm-2b --steps 50 [--wait]
    repro-torch-fleet queue  --port P
    repro-torch-fleet status --port P [--json]
    repro-torch-fleet cancel --port P JOB
    repro-torch-fleet shutdown --port P

``serve`` runs a master in job-service mode: clients submit jobs, the
master leases them onto idle agents (on the card unless ``--device
cpu``; every agent shares it), dead agents' jobs requeue and resume from
their last checkpoint. All other subcommands are one-shot RPCs against a
running master (``repro_torch.launch.wire.request``). The requests and
replies are the reference's, so either package's client can talk to
either master.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import List, Optional

from repro_torch.launch.wire import WireError, request

__all__ = ["main"]


def _cmd_serve(args: argparse.Namespace) -> int:
    from repro_torch.launch.fleet import FleetConfig, FleetMaster
    cfg = FleetConfig(heartbeat_interval=args.heartbeat,
                      suspect_after=args.heartbeat * 3,
                      dead_after=args.heartbeat * 6,
                      checkpoint_every=args.checkpoint_every,
                      respawn=args.respawn, device=args.device)
    with FleetMaster(args.ckpt_dir, config=cfg) as master:
        master.start(n_agents=args.agents)
        if args.port_file:
            with open(args.port_file, "w") as f:
                f.write(str(master.port))
        print(f"repro-torch-fleet master on 127.0.0.1:{master.port} "
              f"({args.agents} agents on {args.device or 'cuda'}, "
              f"ckpt_dir={args.ckpt_dir})", flush=True)
        try:
            while not master._closing:
                time.sleep(0.2)
        except KeyboardInterrupt:
            pass
    return 0


def _wire_spec(args: argparse.Namespace) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.launch.cluster import JobSpec
    from repro_torch.launch.wire import spec_to_wire
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, dtype=args.dtype)
    return spec_to_wire(JobSpec(cfg, batch=args.batch, seq=args.seq,
                                accum_steps=args.accum_steps,
                                seed=args.seed))


def _cmd_submit(args: argparse.Namespace) -> int:
    resp = request(args.host, args.port,
                   {"type": "submit", "spec": _wire_spec(args),
                    "steps": args.steps, "name": args.name,
                    "sub_batch": args.sub_batch})
    if not resp.get("ok"):
        print(f"error: {resp.get('error')}", file=sys.stderr)
        return 1
    name = resp["job"]
    print(f"submitted {name}")
    if not args.wait:
        return 0
    while True:
        time.sleep(args.poll)
        status = request(args.host, args.port, {"type": "status"})
        job = status.get("jobs", {}).get(name)
        if job is None:
            print(f"error: job {name!r} vanished", file=sys.stderr)
            return 1
        if job["finished"] or job["failed"] or job["cancelled"]:
            print(json.dumps({name: job}, indent=2))
            return 0 if job["finished"] else 1
        print(f"  {name}: {job['steps']}/{job['total_steps']} steps",
              flush=True)


def _cmd_queue(args: argparse.Namespace) -> int:
    resp = request(args.host, args.port, {"type": "queue"})
    print(json.dumps({"queue": resp.get("queue", []),
                      "jobs": {n: j["steps"]
                               for n, j in resp.get("jobs", {}).items()
                               if not j["finished"]}}, indent=2))
    return 0


def _cmd_status(args: argparse.Namespace) -> int:
    resp = request(args.host, args.port, {"type": "status"})
    resp.pop("ok", None)
    if args.json:
        print(json.dumps(resp, indent=2))
        return 0
    print(f"master 127.0.0.1:{resp.get('port')}")
    for aid, a in sorted(resp.get("agents", {}).items()):
        print(f"  agent {aid}: {a['state']}, leases={a['leases']}, "
              f"watermark={a['watermark']}")
    for name, j in sorted(resp.get("jobs", {}).items()):
        state = ("finished" if j["finished"] else
                 "failed" if j["failed"] else
                 "cancelled" if j["cancelled"] else "running")
        print(f"  job {name}: {j['steps']}/{j['total_steps']} {state} "
              f"(redispatches={j['redispatches']})")
    print(f"  queue: {resp.get('queue', [])}")
    print(f"  stats: {resp.get('stats', {})}")
    return 0


def _cmd_cancel(args: argparse.Namespace) -> int:
    resp = request(args.host, args.port,
                   {"type": "cancel", "job": args.job})
    print("cancelled" if resp.get("ok") else "no such running job")
    return 0 if resp.get("ok") else 1


def _cmd_shutdown(args: argparse.Namespace) -> int:
    resp = request(args.host, args.port, {"type": "shutdown"})
    print("shutdown requested" if resp.get("ok") else "refused")
    return 0 if resp.get("ok") else 1


def _add_client_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro-torch-fleet",
        description="master/agent fleet runtime for schedule replay")
    sub = ap.add_subparsers(dest="cmd", required=True)

    serve = sub.add_parser("serve", help="run a master + N agents")
    serve.add_argument("--agents", type=int, default=2)
    serve.add_argument("--ckpt-dir", required=True)
    serve.add_argument("--port-file", default=None,
                       help="write the bound port here once listening")
    serve.add_argument("--heartbeat", type=float, default=0.25)
    serve.add_argument("--checkpoint-every", type=int, default=5)
    serve.add_argument("--respawn", action="store_true",
                       help="replace agents the fleet declares dead")
    serve.add_argument("--device", default=None,
                       help="the agents' device: cuda (default) or cpu")
    serve.set_defaults(fn=_cmd_serve)

    submit = sub.add_parser("submit", help="submit a training job")
    _add_client_args(submit)
    submit.add_argument("--arch", default="minicpm-2b")
    submit.add_argument("--steps", type=int, required=True)
    submit.add_argument("--batch", type=int, default=2)
    submit.add_argument("--seq", type=int, default=32)
    submit.add_argument("--accum-steps", type=int, default=1)
    submit.add_argument("--seed", type=int, default=0)
    submit.add_argument("--dtype", default="float32")
    submit.add_argument("--sub-batch", type=int, default=None)
    submit.add_argument("--name", default=None)
    submit.add_argument("--reduced", action="store_true",
                        help="use the test-sized model config")
    submit.add_argument("--wait", action="store_true",
                        help="poll until the job reaches a terminal state")
    submit.add_argument("--poll", type=float, default=1.0)
    submit.set_defaults(fn=_cmd_submit)

    for name, fn, hlp in (("queue", _cmd_queue, "show pending jobs"),
                          ("status", _cmd_status, "fleet status"),
                          ("shutdown", _cmd_shutdown, "stop the master")):
        p = sub.add_parser(name, help=hlp)
        _add_client_args(p)
        if name == "status":
            p.add_argument("--json", action="store_true")
        p.set_defaults(fn=fn)

    cancel = sub.add_parser("cancel", help="cancel a job")
    _add_client_args(cancel)
    cancel.add_argument("job")
    cancel.set_defaults(fn=_cmd_cancel)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except (WireError, ConnectionRefusedError, OSError) as exc:
        print(f"error: cannot reach master: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
