#!/usr/bin/env python3
"""The decode-attention kernel alone on one GPU: chip_smoke.py's check and
timing of it, without the rest of the smoke run.

    python3 scripts/torch_decode_attention_timing.py   # one CUDA card and nvcc

Builds cluster_anywhere_tpu_torch/ops/csrc/decode_attention.cu (its
`-Xptxas -v` register and spill lines printed), then runs
chip_smoke.phase_decode_check (the kernel against its plain version, row
by row) and chip_smoke.phase_decode_timing (kernel, SDPA and plain version
at the 7B chat cell's cache and the flagship's decode step, beside the
bytes bound), and prints the card's name and power limit.
"""

from __future__ import annotations

import importlib
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # the package and chip_smoke


def main():
    import torch

    import chip_smoke
    from cluster_anywhere_tpu_torch.ops import _build

    attn = importlib.import_module("cluster_anywhere_tpu_torch.ops.attention")
    lib = _build.build("decode_attention")
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line and " 0 bytes spill" not in line:
            print("[build]", line.strip(), flush=True)
    print(f"[card] {chip_smoke.gpu_clocks('name,power.limit')}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    chip_smoke.phase_decode_check(torch, attn, gen)
    chip_smoke.phase_decode_timing(torch, attn, gen)


if __name__ == "__main__":
    main()
