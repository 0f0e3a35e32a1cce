#!/usr/bin/env python3
"""Whether GPU actors that start working at once starve their own
heartbeats past the head's bound, on one GPU.

    python3 scripts/torch_heartbeat_stress.py [--actors N] [--rounds R]

Starts a session of the port's runtime (heartbeat bound:
health_check_period_s x failure threshold = 10 s; a silent worker whose
process is at work is given up to the head's BUSY_SILENCE_FACTOR bounds),
creates N actors at 1/N of the card each, and has all of them at once do
what a Tune trial or a Train worker does first: import torch, create the
CUDA context and build the flagship (entry.flagship_cfg(), seed 0) on the
card, then one forward step of 8 x 1024 tokens.  R rounds, each with fresh
actors.  Prints one JSON line: the actors that finished and the errors of
those that did not, the head's widest heartbeat gap and whose it was, the
silences it let pass because the worker was at work (worker_silent
events), the causes of the workers it declared dead, and each actor's
seconds of work; then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def loader_class(ca, share):
    @ca.remote(num_gpus=share, num_cpus=0)
    class Loader:
        def ready(self):
            return os.getpid()

        def load(self):
            import time

            t0 = time.perf_counter()
            import torch

            from cluster_anywhere_tpu_torch.entry import flagship_cfg
            from cluster_anywhere_tpu_torch.models.transformer import forward, init_params

            torch.cuda.init()
            cfg = flagship_cfg()
            model = init_params(cfg, 0, device="cuda")
            with torch.no_grad():
                ids = torch.zeros((8, 1024), dtype=torch.long, device="cuda")
                forward(model, ids).float().sum().item()
            return time.perf_counter() - t0

    return Loader


def events(session_dir, kind, *keys):
    out = []
    with open(os.path.join(session_dir, "events.jsonl")) as f:
        for line in f:
            ev = json.loads(line)
            if ev.get("event") == kind:
                out.append([ev.get("worker_id")] + [ev.get(k) for k in keys])
    return out


def run(n, rounds):
    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch.core import api

    ca.init(num_cpus=2)
    try:
        Loader = loader_class(ca, 1.0 / n)
        done, errors, seconds = 0, [], []
        for _ in range(rounds):
            actors = [Loader.remote() for _ in range(n)]
            ca.get([a.ready.remote() for a in actors], timeout=300)
            refs = [a.load.remote() for a in actors]
            for ref in refs:
                try:
                    seconds.append(round(ca.get(ref, timeout=600), 2))
                    done += 1
                except Exception as e:
                    errors.append(str(e).splitlines()[0][:300])
            for a in actors:
                ca.kill(a)
            time.sleep(2.0)  # the killed workers' exits reach the head
        stats = ca.cluster_stats()
        return {"actors": n * rounds, "finished": done, "errors": errors,
                "widest_gap_s": round(stats.get("max_heartbeat_gap_s", 0.0), 2),
                "widest_gap_worker": stats.get("max_heartbeat_gap_worker"),
                "worker_silent": events(api._session_dir, "worker_silent", "state",
                                        "proc_state"),
                "worker_died": [d for d in events(api._session_dir, "worker_died", "cause")
                                if d[1] != "signal 9"],
                "load_s": seconds}
    finally:
        ca.shutdown()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--actors", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    print(json.dumps(run(args.actors, args.rounds)), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
