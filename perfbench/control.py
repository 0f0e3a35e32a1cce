"""The readings the limits of `correct` are set from, on the card at a
cell's own size, many seeds in one process:

    python -m perfbench.control --workload <name> --seeds 1,2,... --control-seeds 1,2,3

For each seed, the number a run of the cell compares, as the program gives
it (the lower reading).  For each control seed, the same number from the
control, the reference put in the program's place in the precision below
the configuration's (fp8 for bf16 activations), and for a training cell
from each fault that can be planted there: half of each batch left out, the
mean taken over the rest.  A step that returns its state unchanged reads 1
by the change's measure and needs no run.  One JSON row a seed.

A serving cell: one server, the seed's weights loaded anew a seed, a short
window of the cell's mix at its rate (--seconds, from an idle server), the
requests followed to their end, then the cell's sample judged by the
reference.  The control's
reading is the widest gap, under the fp32 reference, of the tokens a
reference in fp8 puts first at the same positions of the same sequences.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

from perfbench import generator, harness, manifest


def serve_readings(cell: Dict, seeds: List[int], control_seeds: List[int], seconds: float,
                   device) -> List[Dict]:
    from perfbench.cells import serve_open_loop as serve

    m = manifest.model_dims(cell["config"])
    mix, limits = cell["traffic"], cell["config"]["limits"]["serve"]
    server = serve.setup(m, mix["engine"], seeds[0], device)
    rows = []
    for seed in seeds:
        harness.load_weights(server.cb.params, m, seed)
        reqs = generator.open_loop(mix, seconds, seed, m["vocab"])
        run = serve.drive(server, reqs, 0.0, seconds, mix["drain_s"])
        sample = serve.sample_requests(run["recs"], seed, limits["served_tokens"],
                                       limits["max_requests"])
        row = {"seed": seed, "requests": len(sample),
               "served_tokens": sum(len(r["tokens"]) for r in sample),
               "failed": sum(1 for r in run["recs"] if not r["finished"]),
               "logit_gap": serve.widest_gap(m, seed, sample, device)}
        if seed in control_seeds:
            row["control_fp8_logit_gap"] = serve.widest_gap(m, seed, sample, device, fmt="fp8")
        rows.append(row)
        print(json.dumps(row), flush=True)
    serve.release(server)
    return rows


def train_readings(cell: Dict, seeds: List[int], control_seeds: List[int], device) -> List[Dict]:
    from perfbench.cells import train_steps as train

    m = manifest.model_dims(cell["config"])
    mix = cell["traffic"]
    n_check = mix["check_steps"]

    def program(seed, half=False):
        train_step, model, opt = train.build(m, mix, seed, device)

        def feed(step):
            ids = generator.train_batch(mix, seed, step, m["vocab"], device)
            return {"ids": ids[: ids.shape[0] // 2] if half else ids}

        prog, model, opt = train.first_steps(train_step, model, opt, feed, n_check, m, seed)
        del train_step, model, opt
        harness.free(device)
        return prog

    rows = []
    for seed in seeds:
        prog = program(seed)
        ref = train.reference_readings(m, mix, seed, device)
        row = {"seed": seed, **train.readings(prog, ref, m),
               "losses": prog["losses"], "ref_losses": ref["losses"]}
        if seed in control_seeds:
            ctrl = train.reference_readings(m, mix, seed, device, fmt="fp8")
            row["control_fp8"] = train.readings(ctrl, ref, m)
            row["fault_half_batch"] = train.readings(program(seed, half=True), ref, m)
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=15)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        sys.exit("perfbench.control: no CUDA device")
    seeds = [int(s) for s in args.seeds.split(",")]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    cell = manifest.cell(manifest.load(), args.workload)
    device = torch.device("cuda", 0)
    if cell["traffic"]["kind"] == "serve_open_loop":
        serve_readings(cell, seeds, control, args.seconds, device)
    else:
        train_readings(cell, seeds, control, device)


if __name__ == "__main__":
    main()
