"""step_mfu.chat: the whole serving step's share of the bf16 peak over the
profiled sub-window: the FLOPs its admissions' real prompt tokens and its
decode steps' live slots need (counts.prefill_flops,
counts.decode_step_flops) over the sub-window's seconds.  It bounds what
the kernel rooflines beside it can claim."""

from perfbench import counts


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["window_s"]:
        return None
    m = ctx["dims"]
    flops = sum(counts.prefill_flops(m, n) for a in ctx.get("admissions") or []
                if a["profiled"] for n in a["lens"])
    flops += sum(counts.decode_step_flops(m, d["live"], d["kv_tokens"])
                 for d in ctx.get("decodes") or [] if d["profiled"])
    return flops / tr["window_s"] / counts.BF16_FLOPS * 100 if flops else None
