"""The one traffic generator: a mix's parameters (traffic/<mix>.json) and a
seed in, the requests or batches of one run out.

Every seed gets the same work: the arrival times and each request's prompt
and output lengths are drawn once from the mix's `set_seed`, and the run's
seed draws the token ids.  So two seeds offer the same requests at the same
moments, with other content.  (Dealing the lengths out in a seeded order
changed the work inside a 50-s window by 10% from seed to seed.)
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, List

import numpy as np


def derive(seed: int, *tags: Any) -> int:
    """A 63-bit seed for one purpose of one run (seeds may exceed 32 bits)."""
    h = hashlib.sha256(":".join(str(x) for x in (int(seed),) + tags).encode())
    return int.from_bytes(h.digest()[:8], "little") >> 1


def draw(spec: Dict[str, Any], n: int, rng: np.random.Generator) -> np.ndarray:
    """n values of a length distribution: lognormal (median, sigma) or
    uniform (min, max); clipped to [min, max] and rounded to integers."""
    dist = spec["dist"]
    if dist == "lognormal":
        v = spec["median"] * np.exp(spec["sigma"] * rng.standard_normal(n))
    elif dist == "uniform":
        v = rng.integers(spec["min"], spec["max"] + 1, n)
    else:
        raise ValueError(f"unknown distribution {dist!r}")
    return np.rint(np.clip(v, spec.get("min", -np.inf), spec.get("max", np.inf))).astype(np.int64)


def open_loop(mix: Dict[str, Any], seconds: float, seed: int, vocab: int) -> List[Dict[str, Any]]:
    """The requests of one open-loop run: round(rate * seconds) requests,
    each {"due_s", "prompt" (token ids), "max_new_tokens"}.  Gaps are
    exponential at the mix's rate (Poisson arrivals) or gamma with its cv
    (bursts), the same for every seed, and scaled down where need be so
    that the last request is due inside the window."""
    arr = mix["arrivals"]
    n = max(1, int(round(arr["rate_per_s"] * seconds)))
    base = np.random.default_rng(mix.get("set_seed", 0))
    mean = 1.0 / arr["rate_per_s"]
    if arr["process"] == "poisson":
        gaps = base.exponential(mean, n)
    elif arr["process"] == "gamma":
        shape = 1.0 / arr["cv"] ** 2
        gaps = base.gamma(shape, mean / shape, n)
    else:
        raise ValueError(f"unknown arrival process {arr['process']!r}")
    prompt_lens = draw(mix["prompt_tokens"], n, base)
    output_lens = draw(mix["output_tokens"], n, base)
    gaps *= min(1.0, seconds * (1.0 - 0.5 / n) / gaps.sum())
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    rng = np.random.default_rng(derive(seed, "open_loop"))
    return [
        {
            "index": i,
            "due_s": float(due[i]),
            "prompt": rng.integers(0, vocab, int(prompt_lens[i])).tolist(),
            "max_new_tokens": int(output_lens[i]),
        }
        for i in range(n)
    ]


def train_batch(mix: Dict[str, Any], seed: int, step: int, vocab: int, device):
    """The ids [B, T + 1] of training step `step` (1-based), drawn on the
    device from the run's seed: every step's rows differ."""
    import torch

    g = torch.Generator(device=device).manual_seed(derive(seed, "batch", step))
    b, t = mix["batch"], mix["seq_len"]
    return torch.randint(0, vocab, (b, t + 1), generator=g, device=device, dtype=torch.int64)
