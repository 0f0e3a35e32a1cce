"""decode_mbu.chat: the decode steps' share of the HBM peak over the
profiled sub-window: the bytes the steps need (weights once a step, the live
slots' K/V at their real lengths; counts.decode_step_bytes) over the device
time of the kernels they ran (those in a step outside its admission)."""

from perfbench import counts, profiling


def read(ctx):
    tr = ctx.get("trace")
    steps = [d for d in ctx.get("decodes") or [] if d["profiled"]]
    if not tr or not steps:
        return None
    ms = profiling.phase_ms(tr, "step")
    if ms <= 0:
        return None
    nbytes = sum(counts.decode_step_bytes(ctx["dims"], d["live"], d["kv_tokens"]) for d in steps)
    return nbytes / (ms / 1e3) / counts.HBM_BYTES_S * 100
