"""Where a device-plane hop of the flagship's KV cache spends its time.

A `DeviceRef` fetch or a tensor-transport DAG edge moves the generate
cell's prefill output (cache {k, v} [8 layers, 8, 544, 4, 128] bf16 and
logits [8, 32000] fp32: 72.3 MB) from one process's card to another's
through the host.  This script times each step of that path that runs
inside one process, on one card, in turns (median of --reps):

  pack   pack_device_value: one D2H copy of each leaf into a host buffer
  blob   serialization.pack of the envelope: the one bytes blob a fetch's
         RPC reply carries (a channel scatter-writes the buffers instead)
  open   serialization.unpack of the blob: the envelope over the blob
  land   unpack_device_value: the H2D copy of each leaf, synchronised

What is left of chip_smoke.py's hop (phase 9, device-ref) beyond their sum
is the runtime's: the RPC round trip of the blob between the processes.

    python3 scripts/torch_transport_cost.py [--reps N] [--device cuda]

Prints one JSON object: ms and GB/s of each step, the card and its power
limit.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from cluster_anywhere_tpu_torch.channel import device_transport as dt
from cluster_anywhere_tpu_torch.core import serialization
from cluster_anywhere_tpu_torch.entry import flagship_cfg

B, T, N_NEW = 8, 512, 32  # chip_smoke.py's generate cell


def _value(device):
    """The prefill output's shapes and dtypes, random from seed 0."""
    cfg = flagship_cfg()
    gen = torch.Generator(device=device).manual_seed(0)
    shape = (cfg.n_layers, B, T + N_NEW, cfg.n_kv_heads, cfg.d_head)
    cache = {k: torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
             for k in ("k", "v")}
    logits = torch.randn((B, cfg.vocab_size), generator=gen, device=device)
    return {"logits": logits, "cache": cache, "t_prompt": T}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device: the timings are the card's (pass --device cpu to try the script)")
    value = _value(device)
    nbytes = sum(t.numel() * t.element_size()
                 for t in (value["logits"], value["cache"]["k"], value["cache"]["v"]))
    steps = {"pack": [], "blob": [], "open": [], "land": []}
    for _ in range(args.reps + 1):  # the first round warms the allocators up
        _sync(device)
        t0 = time.perf_counter()
        env = dt.pack_device_value(value)
        t1 = time.perf_counter()
        blob = serialization.pack(env)
        t2 = time.perf_counter()
        opened = serialization.unpack(blob)
        t3 = time.perf_counter()
        landed = dt.unpack_device_value(opened)
        _sync(device)
        t4 = time.perf_counter()
        for name, a, b in (("pack", t0, t1), ("blob", t1, t2), ("open", t2, t3), ("land", t3, t4)):
            steps[name].append(b - a)
        del env, blob, opened
    for k in ("k", "v"):
        if not torch.equal(landed["cache"][k].view(torch.int16), value["cache"][k].view(torch.int16)):
            sys.exit(f"the landed cache's {k} differs from the sent one")
    out = {}
    for name, ts in steps.items():
        med = float(np.median(ts[1:]))
        out[name] = {"ms": med * 1e3, "gb_s": nbytes / med / 1e9}
    out["sum_ms"] = sum(v["ms"] for v in out.values())
    card = "cpu"
    if device.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else torch.cuda.get_device_name()
    print(json.dumps({"bytes": nbytes, "reps": args.reps, "steps": out, "device": str(device),
                      "card": card}))


if __name__ == "__main__":
    main()
