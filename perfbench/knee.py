"""Find a serving cell's knee once, on the card: the highest rate its server
sustains without a growing backlog.

    python -m perfbench.knee --workload dsllm7b.chat --rates 2,2.5,3,3.5,4 --seconds 40

One process builds the cell's server once (its configuration, engine and
weights from --seed), then offers the cell's mix at each rate in turn for
the mix's warm-up and then --seconds, follows the window's requests to
their end (for at most --drain), and prints one row a rate: offered
requests a second and those finished inside the window, the requests still
queued for a slot as the window closed, TTFT p50 and p95, ITL p95 and
output tokens a second.
The cell's traffic then takes about four fifths of the knee as its rate.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True, help="comma-separated requests a second")
    ap.add_argument("--seconds", type=float, default=40)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--drain", type=float, default=60, help="seconds to follow requests after a window")
    args = ap.parse_args(argv)

    import torch

    from perfbench import manifest
    from perfbench.cells import serve_open_loop as serve

    if not torch.cuda.is_available():
        sys.exit("perfbench.knee: no CUDA device")
    cell = manifest.cell(manifest.load(), args.workload)
    m = manifest.model_dims(cell["config"])
    server = serve.setup(m, cell["traffic"]["engine"], args.seed, torch.device("cuda", 0))
    rows = []
    for rate in (float(r) for r in args.rates.split(",")):
        mix = copy.deepcopy(cell["traffic"])
        mix["arrivals"]["rate_per_s"] = rate
        reqs = serve.traffic(mix, args.seconds, args.seed, m["vocab"])
        run = serve.drive(server, reqs, mix["warm_s"], args.seconds, args.drain)
        e2e = serve.end_to_end(run, args.seconds)
        measured = [r for r in run["recs"] if r["measured"]]
        done = sum(1 for r in measured if r["finished"] and r["times"][-1] <= run["t_end"])
        row = {"offered_req_s": len(measured) / args.seconds,
               "served_req_s": done / args.seconds,
               "backlog_at_close": run["backlog"],
               "failed": sum(1 for r in measured if not r["finished"]), **e2e}
        rows.append(row)
        print(json.dumps({"rate": rate, **row}), flush=True)
    serve.release(server)


if __name__ == "__main__":
    main()
