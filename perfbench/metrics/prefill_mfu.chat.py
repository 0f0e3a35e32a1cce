"""prefill_mfu.chat: the FLOPs the admitted prompts' real tokens need
(counts.prefill_flops) over the device time of the admissions in the
profiled sub-window, against the bf16 peak."""

from perfbench import counts, profiling


def read(ctx):
    tr = ctx.get("trace")
    adm = [a for a in ctx.get("admissions") or [] if a["profiled"]]
    if not tr or not adm:
        return None
    ms = profiling.phase_ms(tr, "admit")
    if ms <= 0:
        return None
    flops = sum(counts.prefill_flops(ctx["dims"], n) for a in adm for n in a["lens"])
    return flops / (ms / 1e3) / counts.BF16_FLOPS * 100
