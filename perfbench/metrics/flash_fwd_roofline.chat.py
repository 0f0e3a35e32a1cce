"""flash_fwd_roofline.chat: the least time of the flash forward launches in
the profiled admissions (one a layer, each over one prompt's real tokens:
counts.flash_fwd_cost and counts.bound_ms) over the flash_fwd kernels'
device time there."""

from perfbench import counts, profiling


def read(ctx):
    tr = ctx.get("trace")
    adm = [a for a in ctx.get("admissions") or [] if a["profiled"]]
    if not tr or not adm:
        return None
    ms = profiling.kernel_ms(tr, ("flash_fwd",), phase="admit")
    if ms <= 0:
        return None
    m = ctx["dims"]
    bound = 0.0
    for n in (n for a in adm for n in a["lens"]):
        flops, nbytes = counts.flash_fwd_cost(m["n_heads"], m["d_head"], [n])
        bound += m["n_layers"] * counts.bound_ms(nbytes, flops)[0]
    return bound / ms * 100
