"""Run one cell of BENCHMARK.json once on the card and print its result.

    python -m perfbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The cell's traffic names its driver
(cells/<kind>.py), which builds the port's entry point, warms up the cell's
own shapes, measures for --seconds, and then checks what the timed path
produced against the plain reference (reference.py).  --trace 0 reports the
cell's end-to-end metrics, --trace 1 its per-layer metrics (read by
metrics/<name>.py from a profiled sub-window).  The last line of standard
output is one JSON object; the numbers compared, each with its limit, are the
last lines of standard error and the last key of that object.  With no CUDA
card, or fewer than the cell asks for, it exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def process_start() -> float:
    """time.time() at this process's start (from /proc; now, failing that)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


FORBIDDEN = ("jax", "jaxlib", "flax", "cluster_anywhere_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def fail(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(1)


def device_info(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}


def main(argv=None) -> None:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")

    from perfbench import manifest

    man = manifest.load()
    cell = manifest.cell(man, args.workload)
    chips = int(cell["workload"]["chips"])

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        fail(f"the cell asks for {chips} cards, {torch.cuda.device_count()} found")
    torch.cuda.set_device(0)

    drv = manifest.driver(cell["traffic"]["kind"])
    res = drv.run(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                  device=torch.device("cuda", 0), t_start=t_start)

    bad = forbidden_modules()
    if bad:
        fail(f"JAX or the JAX package was loaded in this process: {', '.join(bad)}")

    units = {m["name"]: m["unit"] for m in man["end_to_end"] + man["per_layer"]}
    wanted = cell["per_layer"] if args.trace else cell["end_to_end"]
    metrics = {}
    for m in wanted:
        name = m["name"]
        if args.trace:
            value = manifest.reader(name)(res["ctx"])
        else:
            value = res["e2e"].get(name)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
    dev = device_info(chips)
    dev["memory_peak_bytes"] = int(res["memory_peak_bytes"])
    if args.trace:
        dev["busy_s"] = res["trace"]["busy_s"]
        dev["window_s"] = res["trace"]["window_s"]
    line = {
        "correct": bool(res["correct"]),
        "attempted": int(res["attempted"]),
        "failed": int(res["failed"]),
        "metrics": metrics,
        "device": dev,
    }
    if args.trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"perfbench check {name}: {c['value']!r} against limit {c['limit']!r}"
              f" ({'pass' if c['pass'] else 'FAIL'})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
