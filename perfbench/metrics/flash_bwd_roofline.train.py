"""flash_bwd_roofline.train: the least time of the profiled steps' dQ and
dK/dV launches (one each a layer a step; counts.flash_bwd_costs,
counts.bound_ms) over the two kernels' device time."""

from perfbench import counts, profiling


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    ms = profiling.kernel_ms(tr, ("bwd_dq", "bwd_dkv"))
    if ms <= 0:
        return None
    m, mix = ctx["dims"], ctx["mix"]
    costs = counts.flash_bwd_costs(mix["batch"], mix["seq_len"], m["n_heads"], m["d_head"])
    bound = sum(counts.bound_ms(nbytes, flops)[0] for flops, nbytes in costs.values())
    return bound * m["n_layers"] * ctx["profiled_steps"] / ms * 100
