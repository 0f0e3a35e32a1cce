"""admit_ms.chat: mean wall ms of one admission (prefill, slot install and
first token) over every admission of the traced run's window, from the
batcher's `_admit` timed on its instance (an admission ends in a
synchronisation: it reads its first token)."""


def read(ctx):
    adm = ctx.get("admissions") or []
    n = sum(a["k"] for a in adm)
    return sum(a["ms"] * a["k"] for a in adm) / n if n else None
