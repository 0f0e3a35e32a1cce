"""optimizer_ms.train: device ms a step in AdamW's kernels (torch's
multi-tensor apply), over the profiled steps."""

from perfbench import profiling


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    ms = profiling.kernel_ms(tr, ("multi_tensor", "adam"))
    return ms / ctx["profiled_steps"] if ms > 0 else None
