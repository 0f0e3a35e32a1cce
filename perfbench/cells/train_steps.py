"""Training steps back to back through the port's make_train_step.

Set-up builds one model and its AdamW state (the port's default optimizer,
at the mix's learning rate), copies the seed's fp32 weights into it, and
drives it through the first `check_steps` steps on the feed's batches:
those warm up every shape and give the program's readings (each step's
loss; every leaf's first gradient, as AdamW's first moment holds it after
step 1; every leaf's change after the steps).  The window then runs the
same object on further batches of the same feed until --seconds have
passed, and ends in a synchronize.  With trace, a few more steps run under
the profiler.  Then the program's state is freed and the reference
(reference.train_readings) runs the first steps again in fp32 from the
seed.
"""

from __future__ import annotations

import time
from typing import Dict

from .. import generator, harness, profiling, reference
from .. import weights as W
from ..manifest import model_dims


def program_change_norms(model, m: Dict, seed: int) -> Dict[str, float]:
    """Every leaf's distance from the seed's starting weights."""
    import torch

    params = dict(model.named_parameters())
    out = {}
    with torch.no_grad():
        for kind in W.KINDS:
            p0 = W.make(m, seed, kind, model.device, torch.float32)
            for name, k, i in W.leaves(m):
                if k == kind:
                    out[name] = float((params[name].float() - W.pick(p0, i)).norm())
            del p0
    return out


def readings(prog: Dict, ref: Dict, m: Dict) -> Dict:
    """The numbers a training run compares with the reference.  By the worst
    leaf, the gap between the program's and the reference's norms of the
    first gradient and of the change after the checked steps, each against
    the reference's norm of that leaf or of the median leaf, whichever is
    larger; leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone and are left out of the change.
    Beside them the widest relative gap of the steps' losses, which is read
    and not compared (PERF.md: no control or fault moves it three times)."""
    names = [n for n, _, _ in W.leaves(m)]
    grad_gap, grad_at = harness.worst_leaf_gap(prog["grad_norms"], ref["grad_norms"], names)
    med = harness.median_leaf(ref["grad_norms"])
    moving = [n for n in names if ref["grad_norms"][n] >= med / 1000]
    change_gap, change_at = harness.worst_leaf_gap(prog["change_norms"], ref["change_norms"], moving)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    harness.log(f"losses program {prog['losses']} reference {ref['losses']} (widest relative gap "
                f"{loss_gap:.3g}, read, not compared); worst gradient leaf {grad_at}, worst change "
                f"leaf {change_at}; {len(names) - len(moving)} leaves left out of the change")
    return {"grad_norm_gap": grad_gap, "change_norm_gap": change_gap, "loss_gap": loss_gap}


def compare(prog: Dict, ref: Dict, limits: Dict, m: Dict) -> Dict:
    r = readings(prog, ref, m)
    return {k: harness.check(r[k], limits[k]) for k in ("grad_norm_gap", "change_norm_gap")}


def build(m: Dict, mix: Dict, seed: int, device):
    """The port's train step and one model, the seed's fp32 weights copied
    in, with its AdamW state: (train_step, model, opt)."""
    from cluster_anywhere_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        make_train_step,
    )

    tcfg = TransformerConfig(vocab_size=m["vocab"], **harness.port_config_fields(m))
    train_step, init_state = make_train_step(tcfg, learning_rate=mix["lr"], device=device)
    model = TransformerLM(tcfg, device)
    harness.load_weights(model, m, seed)
    model, opt = init_state(model)
    return train_step, model, opt


def first_steps(train_step, model, opt, feed, n_check: int, m: Dict, seed: int):
    """Steps 1..n_check through the window's own call and feed, and the
    program's readings: each step's loss, every leaf's first gradient (the
    first moment AdamW holds after step 1, over 1 - beta1), every leaf's
    change after the steps.  Returns (readings, model, opt)."""
    prog = {"losses": []}
    for step in range(1, n_check + 1):
        model, opt, loss = train_step(model, opt, feed(step))
        prog["losses"].append(float(loss))
        if step == 1:
            beta1 = opt.param_groups[0]["betas"][0]
            # a parameter the optimizer never stepped has no moment: its
            # gradient reads 0
            prog["grad_norms"] = {
                n: float(opt.state[p]["exp_avg"].norm()) / (1 - beta1)
                if "exp_avg" in opt.state.get(p, {}) else 0.0
                for n, p in model.named_parameters()}
    prog["change_norms"] = program_change_norms(model, m, seed)
    return prog, model, opt


def reference_readings(m: Dict, mix: Dict, seed: int, device, fmt: str = "fp32") -> Dict:
    reference.strict_fp32()
    n_check = mix["check_steps"]
    batches = [generator.train_batch(mix, seed, s, m["vocab"], device)
               for s in range(1, n_check + 1)]
    ref = reference.train_readings(m, seed, batches, mix["lr"], mix["weight_decay"], device,
                                   fmt=fmt, steps=n_check)
    harness.free(device)
    return ref


def run(cell: Dict, *, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    import torch

    m = model_dims(cell["config"])
    mix = cell["traffic"]
    limits = cell["config"]["limits"]["train"]
    n_check = mix["check_steps"]
    train_step, model, opt = build(m, mix, seed, device)

    def feed(step):
        return {"ids": generator.train_batch(mix, seed, step, m["vocab"], device)}

    prog, model, opt = first_steps(train_step, model, opt, feed, n_check, m, seed)
    harness.sync(device)

    launches0 = harness.launches()
    step = n_check
    t0 = time.perf_counter()
    setup_s = time.time() - t_start
    while time.perf_counter() - t0 < seconds:
        step += 1
        model, opt, loss = train_step(model, opt, feed(step))
    harness.sync(device)
    window_s = time.perf_counter() - t0
    n_steps = step - n_check
    launches1 = harness.launches()
    finite = bool(torch.isfinite(loss))
    tokens = n_steps * mix["batch"] * mix["seq_len"]
    e2e = {"train_tok_s": tokens / window_s, "setup_s": setup_s}

    ctx = summary = None
    if trace:
        tr = profiling.Trace()
        n_prof = mix["profile"]["steps"]
        tr.begin()
        for _ in range(n_prof):
            step += 1
            with torch.profiler.record_function("perfbench.step"):
                model, opt, loss = train_step(model, opt, feed(step))
        tr.end()
        summary = tr.reduce()
        ctx = {"dims": m, "mix": mix, "trace": summary, "profiled_steps": n_prof,
               "window_steps": n_steps, "window_s": window_s}
    memory_peak = harness.peak_bytes(device)
    harness.log(f"{n_steps} steps in {window_s:.3f} s ({window_s / n_steps * 1e3:.2f} ms a step), "
                f"e2e {e2e}, peak {memory_peak / 1e9:.2f} GB, last loss finite {finite}")
    del model, opt, train_step, loss
    harness.free(device)

    t_ref = time.perf_counter()
    ref = reference_readings(m, mix, seed, device)
    harness.log(f"reference: {n_check} steps in {time.perf_counter() - t_ref:.1f} s")

    checks = compare(prog, ref, limits, m)
    if device.type == "cuda":  # the port counts kernel launches, not its CPU path
        want = n_steps * m["n_layers"]
        checks["flash_launches_off"] = harness.check(
            max(abs(launches1[k] - launches0[k] - want) for k in launches1), 0)
    out = {
        "correct": finite and all(c["pass"] for c in checks.values()),
        "attempted": n_steps,
        "failed": 0 if finite else 1,
        "e2e": e2e,
        "memory_peak_bytes": memory_peak,
        "checks": checks,
        "ctx": ctx,
    }
    if trace:
        out["trace"] = {"busy_s": summary["busy_s"], "window_s": summary["window_s"]}
        out["breakdown"] = profiling.breakdown(summary)
    return out
