#!/usr/bin/env python3
"""Where the time of the flash-attention forward kernel goes, on one GPU.

    python3 scripts/torch_flash_fwd_ablation.py [variant ...] [--against CSRC]   # one CUDA card and nvcc

The forward's sibling of torch_flash_bwd_ablation.py (what they share is
in torch_flash_ablation_common.py): builds cluster_anywhere_tpu_torch/ops/csrc/flash_fwd.cu as it is
("source") and variants with one part of its Hopper bf16 kernel taken out
or changed by text substitution (each must match the sources, flash_fwd.cu
and the headers, once, or the script stops), one nvcc each, all started
together, into build/torch_flash_fwd_ablation/.  Then it times every
variant at the two shapes the main path gives the forward, all variants in
turn in one loop, with the L2 flushed and the host's launch hidden behind a
spin kernel before each call, so that every median is device time on the
same clocks (chip_smoke.time_cold_in_turn):
  prefill  B 8, T 512, H 8, D 128, bf16, causal, the rows left-padded to
           128..512 live tokens (the flagship serving prefill);
  train    B 8, T 1024, H 8, D 128, bf16, causal, LSE returned (the
           flagship training step's).
SDPA's forward on the same inputs is timed in the same loop as "sdpa".
The variants that take a part out compute wrong outputs by design; the
source's (and each variant that keeps the function) are held to the plain
version (O row error, bf16 limit 2e-2) before anything is timed.  With
--against CSRC, the flash_fwd.cu of another checkout's
cluster_anywhere_tpu_torch/ops/csrc (same C interface) is timed in the same
loop as the variant "against".  Prints one line per variant and the card's
name and power limit.

Variants:
  source         the kernel as it is
  always_masked  every tile through the masked path (no path for tiles no
                 mask reaches)
  hi_only        P enters P V as one bf16 part (hi) instead of hi + lo
  pipeline       the consumers only wait for each stage and release it: what
                 is left is the TMA loads, the barriers and the epilogue
  no_loads       the products and the softmax on whatever the ring holds:
                 no K or V tile is loaded (Q is)
  one_wg         one consumer warpgroup a block (64 query rows), without
                 setmaxnreg
  stages3        a ring of 3 stages
  keys128        K/V tiles of 128 keys (S by the m64n128 wgmma)
  no_pad_skip    every key tile from key 0 loaded, also those wholly below
                 the pad (the masks still drop those keys)
"""

from __future__ import annotations

import ctypes
import importlib
import os
import sys

import numpy as np

from torch_flash_ablation_common import (ROOT, build_variants, make_variant, parse_args,
                                         print_card, start_watchdog)
from chip_smoke import row_errs, time_cold_in_turn  # the module above puts ROOT on sys.path

HOPPER_HEADING = "// ------------------------------------------ bf16, D 64 and 128: Hopper\n"


def wgmma_m64n128_ss():
    """C++ of the m64n128k16 SS wgmma, its first k-step (D's earlier values
    neither read nor kept) and the rest: the keys128 variant's S = Q K^T
    over a 128-key tile.  The kernel itself issues m64n64 alone."""
    regs = ", ".join(f"%{i}" for i in range(64))
    text = ""
    for name, out, scale_d in (("wgmma_m64n128k16_ss_init", "=f", 0),
                               ("wgmma_m64n128k16_ss", "+f", 1)):
        outs = ", ".join(f'"{out}"(d[{i}])' for i in range(64))
        text += (f"__device__ __forceinline__ void {name}(float (&d)[64], uint64_t a, uint64_t b) {{\n"
                 f'  asm volatile("{{\\n.reg .pred p;\\nsetp.ne.b32 p, %66, 0;\\n"\n'
                 f'               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "\n'
                 f'               "{{{regs}}}, %64, %65, p, 1, 1, 0, 0;\\n}}\\n"\n'
                 f"               : {outs}\n"
                 f'               : "l"(a), "l"(b), "r"({scale_d}));\n}}\n\n')
    return text


VARIANTS = {
    "source": [],
    "always_masked": [("      const bool whole = kt0 + FWD_KEYS <= p.Tkv && kt0 >= pad &&",
                       "      const bool whole = p.T < 0 && kt0 >= pad &&")],
    "hi_only": [
        ("      for (int ks = 0; ks < KS; ++ks) wgmma_rs<D>(o, plo[ks], mnmajor_desc<FWD_KEYS>(v_tile(j), ks));",
         "      for (int ks = 0; ks < 0; ++ks) wgmma_rs<D>(o, plo[ks], mnmajor_desc<FWD_KEYS>(v_tile(j), ks));"),
        ("      for (int ks = 0; ks < KS; ++ks) wgmma_a_frag_split(phi[ks], plo[ks], sc, ks);",
         "      for (int ks = 0; ks < KS; ++ks) wgmma_a_frag(phi[ks], sc, ks);"),
    ],
    "pipeline": [("    const int n_live = qw0 >= p.T || (p.causal && pad >= qw0 + 64) ? 0",
                  "    const int n_live = qw0 >= p.T || p.T > 0 ? 0")],
    "no_loads": [  # the full barriers complete with an arrival alone
        ("""        mbar_arrive_expect_tx(full_k(j), KV_TILE);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          tma_load_4d(k_tile(j) + nb * FWD_KEYS * 128, &maps.k, full_k(j), 64 * nb, h,
                      (first + j) * FWD_KEYS, b);
""", "        mbar_arrive(full_k(j));\n"),
        ("""        mbar_arrive_expect_tx(full_v(i), KV_TILE);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb)
          tma_load_4d(v_tile(i) + nb * FWD_KEYS * 128, &maps.v, full_v(i), 64 * nb, h,
                      (first + i) * FWD_KEYS, b);
""", "        mbar_arrive(full_v(i));\n"),
    ],
    "one_wg": [("constexpr int FWD_CONSUMERS = 2;", "constexpr int FWD_CONSUMERS = 1;"),
               ("    regs_dealloc<PRODUCER_REGS>();\n", ""),
               ("    regs_alloc<CONSUMER_REGS>();\n", "")],
    "stages3": [("constexpr int FWD_STAGES = 2;", "constexpr int FWD_STAGES = 3;")],
    "keys128": [("constexpr int FWD_KEYS = 64;", "constexpr int FWD_KEYS = 128;"),
                ("      wgmma_m64n64k16_ss_init(sc,", "      wgmma_m64n128k16_ss_init(sc,"),
                ("        wgmma_m64n64k16_ss(sc,", "        wgmma_m64n128k16_ss(sc,"),
                (HOPPER_HEADING, wgmma_m64n128_ss() + HOPPER_HEADING)],
    "no_pad_skip": [
        ("  const int first = pad / FWD_KEYS;", "  const int first = 0;"),
        ("  const int n_tiles = pad < kv_end ? (kv_end + FWD_KEYS - 1) / FWD_KEYS - first : 0;",
         "  const int n_tiles = (kv_end + FWD_KEYS - 1) / FWD_KEYS - first;"),
    ],
}
EXACT = ("source", "always_masked", "one_wg", "stages3", "keys128", "no_pad_skip", "against")


def main(names, against=None) -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_flash_fwd_ablation: needs one CUDA card", file=sys.stderr)
        return 1
    attn = importlib.import_module("cluster_anywhere_tpu_torch.ops.attention")
    from cluster_anywhere_tpu_torch.ops import _build

    out_root = os.path.join(ROOT, "build", "torch_flash_fwd_ablation")
    names = names + (["against"] if against else [])
    dirs = {n: make_variant(n, out_root, str(_build.CSRC), VARIANTS, "flash_fwd.cu", against)
            for n in names}
    libs = build_variants(names, dirs, "flash_fwd.cu")
    if libs is None:
        return 1
    watchdog = start_watchdog()
    entries = {}
    for n, lib in libs.items():
        fn = lib.flash_fwd
        fn.argtypes = attn._FLASH_ARGTYPES
        fn.restype = ctypes.c_int
        entries[n] = fn

    gen = torch.Generator(device="cuda").manual_seed(0)
    b, t, h, d = 8, 512, 8, 128
    pre = tuple(torch.randn((b, t, h, d), generator=gen, device="cuda").bfloat16() for _ in range(3))
    pre_pad = torch.from_numpy(t - np.linspace(128, t, b).astype(np.int64)).cuda()
    train = tuple(torch.randn((8, 1024, h, d), generator=gen, device="cuda").bfloat16()
                  for _ in range(3))
    shapes = {
        "prefill": (pre, dict(causal=True, pad=pre_pad)),
        "train": (train, dict(causal=True, return_lse=True)),
    }

    def use(n):
        attn._flash_fwd_entry = lambda: entries[n]

    for n in names:
        if n not in EXACT:
            continue
        use(n)
        for shape, ((q, k, v), kw) in shapes.items():
            o = attn.flash_attention(q, k, v, causal=True, pad=kw.get("pad"))
            torch.cuda.synchronize()
            want, _ = attn._flash_attention_plain(q, k, v, causal=True, scale=d ** -0.5,
                                                  pad=kw.get("pad"))
            err = row_errs((o,), (want,))[0]
            print(f"{n} {shape}: O row error {err:.3g} (limit 2e-2)")
            if err > 2e-2:
                print(f"{n} disagrees with the plain version", file=sys.stderr)
                return 1

    def kernel(n, shape):
        (q, k, v), kw = shapes[shape]

        def call():
            use(n)
            attn.flash_attention(q, k, v, **kw)
        return call

    def sdpa(shape):
        (q, k, v), kw = shapes[shape]
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        if "pad" not in kw:
            return lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        keys = torch.arange(q.shape[1], device="cuda")
        mask = ((keys[None, :] <= keys[:, None])[None, None]
                & (keys[None, None, None, :] >= kw["pad"][:, None, None, None]))
        return lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    fns = {(n, s): kernel(n, s) for n in names for s in shapes}
    fns.update({("sdpa", s): sdpa(s) for s in shapes})
    with torch.no_grad():
        times = time_cold_in_turn(torch, fns)
    watchdog.cancel()
    print("device ms, median of 31, L2 flushed; prefill B8 T512 H8 D128 bf16 causal, pad to "
          "128..512 live; train B8 T1024 H8 D128 bf16 causal, LSE returned:")
    for n in names + ["sdpa"]:
        print(f"  {n:14s} prefill {times[(n, 'prefill')]:.4f}  train {times[(n, 'train')]:.4f}")
    print_card()
    return 0


if __name__ == "__main__":
    sys.exit(main(*parse_args(sys.argv[1:], VARIANTS)))
