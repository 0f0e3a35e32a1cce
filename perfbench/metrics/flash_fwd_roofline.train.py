"""flash_fwd_roofline.train: the least time of the profiled steps' flash
forward launches (one a layer a step, causal over [B, T] with the LSE
returned: counts.flash_fwd_cost, counts.bound_ms) over the flash_fwd
kernels' device time."""

from perfbench import counts, profiling


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    ms = profiling.kernel_ms(tr, ("flash_fwd",))
    if ms <= 0:
        return None
    m, mix = ctx["dims"], ctx["mix"]
    flops, nbytes = counts.flash_fwd_cost(m["n_heads"], m["d_head"],
                                          [mix["seq_len"]] * mix["batch"], with_lse=True)
    bound = counts.bound_ms(nbytes, flops)[0] * m["n_layers"] * ctx["profiled_steps"]
    return bound / ms * 100
