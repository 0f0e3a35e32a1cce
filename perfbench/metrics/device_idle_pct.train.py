"""device_idle_pct.train: the share of the profiled sub-window in which no
kernel ran on the card."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return (1 - tr["busy_s"] / tr["window_s"]) * 100
