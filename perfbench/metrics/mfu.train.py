"""mfu.train: the whole step's share of the bf16 peak: chip_smoke.py's
model FLOPs a step (counts.model_flops_per_step, causal-discounted) times
the window's steps, over the window's seconds (host clock, ending in a
synchronize), in the traced run outside its profiled steps."""

from perfbench import counts


def read(ctx):
    if not ctx.get("window_steps"):
        return None
    mix = ctx["mix"]
    flops = counts.model_flops_per_step(ctx["dims"], mix["batch"], mix["seq_len"])
    return flops * ctx["window_steps"] / ctx["window_s"] / counts.BF16_FLOPS * 100
