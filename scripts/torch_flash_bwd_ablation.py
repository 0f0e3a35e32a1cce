#!/usr/bin/env python3
"""Where the time of the flash-attention backward kernels goes, on one GPU.

    python3 scripts/torch_flash_bwd_ablation.py [variant ...] [--against CSRC]   # one CUDA card and nvcc

Builds cluster_anywhere_tpu_torch/ops/csrc/flash_bwd.cu as it is ("source")
and variants with one part of its Hopper dQ and dK/dV kernels taken out by
text substitution (each substitution must match the source once, or the
script stops), one nvcc each, all started together, into
build/torch_flash_bwd_ablation/.  Then it times each variant's dQ and dK/dV
kernels at the flagship training shape (B 8, T 1024, H 8, D 128, bf16,
causal), all variants in turn in one loop, with the L2 flushed and the
host's launch hidden behind a spin kernel before each call, so that every
median is device time on the same clocks.  The variants other than the
source compute wrong gradients by design; the source's are held to the
plain version (row error, bf16 limit 2e-2) before anything is timed.
With --against CSRC, the flash_bwd.cu of another checkout's
cluster_anywhere_tpu_torch/ops/csrc (same C interface) is timed in the same
loop as the variant "against", for a comparison on the same clocks.
Prints one line per variant and the card's name and power limit.

Variants:
  source       the kernels as they are
  no_softmax   P = the scaled score: no mask, no exp
  always_masked  every tile through the masked path (no path for tiles no
               mask reaches)
  no_rs        no register-A product (dV, dK, dQ)
  no_products  no wgmma at all; the softmax math stays
  pipeline     the consumers only wait for each stage and release it: what
               is left is the TMA tile stream, the barriers and the epilogue
  no_epilogue  pipeline, with nothing written
  no_prologue  pipeline, with neither the block's own tiles (Q and dO, or K
               and V) loaded nor anything written
  half_bytes   pipeline, with V (dQ kernel) or dO (dK/dV kernel) not loaded
  stages4      the source with a ring of 4 stages
  ungrouped    the source with the blocks in (b, h)-fastest order
"""

from __future__ import annotations

import ctypes
import importlib
import os
import shutil
import subprocess
import sys
import threading

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

KV_BODY = "      if (keys_live && (!p.causal || qt0 + HKV_ROWS > kw0)) {"
Q_BODY = "      if (qw0 < p.T && (!p.causal || kt0 < qw0 + 64) && kt0 + HQ_KEYS > pad) {"
PIPELINE = [(KV_BODY, "      if (keys_live && p.T < 0) {"),
            (Q_BODY, "      if (qw0 < p.T && p.T < 0) {")]
KV_WHOLE = ("        if (qt0 + HKV_ROWS <= p.T && kw0 + 64 <= p.Tkv && kw0 >= pad &&\n"
            "            (!p.causal || qt0 >= kw0 + 63)) {")
Q_WHOLE = "        if (kt0 + HQ_KEYS <= p.Tkv && kt0 >= pad && (!p.causal || qw0 >= kt0 + HQ_KEYS - 1)) {"
KV_P = KV_WHOLE + """
#pragma unroll
          for (int i = 0; i < 32; ++i)
            st[i] = exp2_approx(st[i] * scale_log2 - lse[col64(i, t)]);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int col = col64(i, t), row = qt0 + col;
            const int key = kw0 + 16 * warp + g + 8 * row_half(i);
            st[i] = row < p.T && mask_ok(row, key, p.Tkv, pad, p.causal)
                        ? exp2_approx(st[i] * scale_log2 - lse[col])
                        : 0.f;
          }
        }
"""
Q_P = Q_WHOLE + """
#pragma unroll
          for (int i = 0; i < 32; ++i)
            sc[i] = exp2_approx(sc[i] * scale_log2 - lse[row_half(i)]);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int r = row_half(i);
            sc[i] = mask_ok(rows[r], kt0 + col64(i, t), p.Tkv, pad, p.causal)
                        ? exp2_approx(sc[i] * scale_log2 - lse[r])
                        : 0.f;
          }
        }
"""
NO_SS = [  # the four S/dP products of each kernel, their first k-step and the rest
    ("        wgmma_m64n64k16_ss_init(st, kmajor_desc<HKV_KEYS>(sk, 64 * wg, 0),\n"
     "                                kmajor_desc<HKV_ROWS>(sq, 0, 0));\n",
     "        for (int i = 0; i < 32; ++i) st[i] = 1e-3f * (i + lane);\n"),
    ("          wgmma_m64n64k16_ss(st, kmajor_desc<HKV_KEYS>(sk, 64 * wg, kk),\n"
     "                             kmajor_desc<HKV_ROWS>(sq, 0, kk));\n", "          ;\n"),
    ("        wgmma_m64n64k16_ss_init(dpt, kmajor_desc<HKV_KEYS>(sv, 64 * wg, 0),\n"
     "                                kmajor_desc<HKV_ROWS>(sdo, 0, 0));\n",
     "        for (int i = 0; i < 32; ++i) dpt[i] = 2e-3f * (i - lane);\n"),
    ("          wgmma_m64n64k16_ss(dpt, kmajor_desc<HKV_KEYS>(sv, 64 * wg, kk),\n"
     "                             kmajor_desc<HKV_ROWS>(sdo, 0, kk));\n", "          ;\n"),
    ("        wgmma_m64n64k16_ss_init(sc, kmajor_desc<HQ_ROWS>(sq, 64 * wg, 0),\n"
     "                                kmajor_desc<HQ_KEYS>(sk, 0, 0));\n",
     "        for (int i = 0; i < 32; ++i) sc[i] = 1e-3f * (i + lane);\n"),
    ("          wgmma_m64n64k16_ss(sc, kmajor_desc<HQ_ROWS>(sq, 64 * wg, kk),\n"
     "                             kmajor_desc<HQ_KEYS>(sk, 0, kk));\n", "          ;\n"),
    ("        wgmma_m64n64k16_ss_init(dp, kmajor_desc<HQ_ROWS>(sdo, 64 * wg, 0),\n"
     "                                kmajor_desc<HQ_KEYS>(sv, 0, 0));\n",
     "        for (int i = 0; i < 32; ++i) dp[i] = 2e-3f * (i - lane);\n"),
    ("          wgmma_m64n64k16_ss(dp, kmajor_desc<HQ_ROWS>(sdo, 64 * wg, kk),\n"
     "                             kmajor_desc<HQ_KEYS>(sv, 0, kk));\n", "          ;\n"),
]
NO_RS = [  # the register operands still feed an accumulator, so nothing is optimised away
    ("wgmma_rs<D>(dv, ap[ks], mnmajor_desc<HKV_ROWS>(sdo, ks));",
     "dv[ks] += __uint_as_float(ap[ks][0]);"),
    ("wgmma_rs<D>(dk, ads[ks], mnmajor_desc<HKV_ROWS>(sq, ks));",
     "dk[ks] += __uint_as_float(ads[ks][0]);"),
    ("wgmma_rs<D>(dq, ads[ks], mnmajor_desc<HQ_KEYS>(sk, ks));",
     "dq[ks] += __uint_as_float(ads[ks][0]);"),
]
NO_EPILOGUE = [("    if (kw0 >= p.Tkv) return;", "    return;"), ("    if (qw0 >= p.T) return;", "    return;")]
VARIANTS = {
    "source": [],
    "no_softmax": [(KV_P, "          for (int i = 0; i < 32; ++i) st[i] = st[i] * scale_log2 - lse[col64(i, t)];\n"),
                   (Q_P, "          for (int i = 0; i < 32; ++i) sc[i] = sc[i] * scale_log2 - lse[row_half(i)];\n")],
    "always_masked": [(KV_WHOLE, "        if (p.T < 0) {"), (Q_WHOLE, "        if (p.T < 0) {")],
    "no_rs": NO_RS,
    "no_products": NO_SS + NO_RS,
    "pipeline": PIPELINE,
    "half_bytes": PIPELINE + [
        ("      mbar_arrive_expect_tx(full(s), 2 * K_TILE);",
         "      mbar_arrive_expect_tx(full(s), K_TILE);"),
        ("        tma_load_4d(sk + K_TILE + nb * HQ_KEYS * 128, &maps.v, full(s), 64 * nb, h, j * HQ_KEYS, b);", ""),
        ("        mbar_expect_tx(full(s), 2 * Q_TILE);", "        mbar_expect_tx(full(s), Q_TILE);"),
        ("          tma_load_4d(sq + Q_TILE + nb * HKV_ROWS * 128, &maps.dout, full(s), 64 * nb, h, qt0, b);", ""),
    ],
    "no_epilogue": PIPELINE + NO_EPILOGUE,
    "no_prologue": PIPELINE + NO_EPILOGUE + [
        ("    mbar_arrive_expect_tx(q_bar, 2 * Q_TILE);", "    mbar_arrive(q_bar);"),
        ("      tma_load_4d(sq + nb * HQ_ROWS * 128, &maps.q, q_bar, 64 * nb, h, q0, b);", ""),
        ("      tma_load_4d(sdo + nb * HQ_ROWS * 128, &maps.dout, q_bar, 64 * nb, h, q0, b);", ""),
        ("      mbar_arrive_expect_tx(kv_bar, 2 * KV_TILE);", "      mbar_arrive(kv_bar);"),
        ("        tma_load_4d(sk + nb * HKV_KEYS * 128, &maps.k, kv_bar, 64 * nb, h, k0, b);", ""),
        ("        tma_load_4d(sv + nb * HKV_KEYS * 128, &maps.v, kv_bar, 64 * nb, h, k0, b);", ""),
    ],
    "stages4": [("constexpr int HOP_STAGES = 2;", "constexpr int HOP_STAGES = 4;")],
    "ungrouped": [
        ("  const int first = blockIdx.x / (HOP_GROUP * n_y) * HOP_GROUP;\n"
         "  const int size = min(HOP_GROUP, n_bh - first);\n"
         "  const int idx = blockIdx.x - first * n_y;\n"
         "  y = idx / size;\n"
         "  bh = first + idx % size;\n",
         "  y = blockIdx.x / n_bh;\n"
         "  bh = blockIdx.x % n_bh;\n"),
    ],
}


def make_variant(name, out_root, csrc, against=None):
    """The variant's sources in out_root/name/, its substitutions applied
    (for "against", the sources of `against` as they are)."""
    if name == "against":
        csrc = against
    src = open(os.path.join(csrc, "flash_bwd.cu")).read()
    for old, new in VARIANTS.get(name, []):
        if src.count(old) != 1:
            raise SystemExit(f"{name}: the substitution of {old.splitlines()[0].strip()!r} "
                             f"matches {src.count(old)} times in flash_bwd.cu")
        src = src.replace(old, new)
    d = os.path.join(out_root, name)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(csrc):
        if f.endswith(".cuh"):
            shutil.copy(os.path.join(csrc, f), d)
    with open(os.path.join(d, "flash_bwd.cu"), "w") as fh:
        fh.write(src)
    return d


def main(names, against=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_bwd_ablation: needs one CUDA card", file=sys.stderr)
        return 1
    attn = importlib.import_module("cluster_anywhere_tpu_torch.ops.attention")
    from cluster_anywhere_tpu_torch.ops import _build

    out_root = os.path.join(ROOT, "build", "torch_flash_bwd_ablation")
    names = names + (["against"] if against else [])
    dirs = {n: make_variant(n, out_root, str(_build.CSRC), against) for n in names}
    built, errors = {}, {}

    def build(n):
        so = os.path.join(dirs[n], "libflash_bwd.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so,
                               os.path.join(dirs[n], "flash_bwd.cu")], capture_output=True, text=True)
        (built if proc.returncode == 0 else errors)[n] = so if proc.returncode == 0 else proc.stderr

    threads = [threading.Thread(target=build, args=(n,)) for n in names]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        for n, err in errors.items():
            print(f"{n}: nvcc failed\n{err[-3000:]}", file=sys.stderr)
        return 1
    entries = {}
    for n, so in built.items():
        lib = ctypes.CDLL(so)
        dq, dkv = lib.flash_bwd_dq, lib.flash_bwd_dkv
        dq.argtypes = attn._BWD_INPUT_ARGTYPES + [ctypes.c_void_p] + attn._BWD_TAIL_ARGTYPES
        dkv.argtypes = attn._BWD_INPUT_ARGTYPES + [ctypes.c_void_p] * 2 + attn._BWD_TAIL_ARGTYPES
        dq.restype = dkv.restype = ctypes.c_int
        entries[n] = (dq, dkv)

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn((8, 1024, 8, 128), generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    kw = dict(causal=True, scale=128 ** -0.5)
    o, lse = attn.flash_attention(q, k, v, causal=True, return_lse=True)
    delta = attn._bwd_delta(o, do)

    def use(n):
        attn._flash_bwd_entries = lambda: entries[n]

    if "source" in entries:
        use("source")
        got = (attn.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
               *attn.flash_bwd_dkv(q, k, v, do, lse, delta, **kw))
        want = attn._bwd_plain_from_delta(q, k, v, do, lse, delta, **kw)
        errs = []
        for g, w in zip(got, want):
            diff, norm = (g.float() - w.float()).norm(dim=-1), w.float().norm(dim=-1)
            errs.append((diff / norm.clamp(min=0.1 * norm.square().mean().sqrt().item())).max().item())
        print(f"source: dQ/dK/dV row error {'/'.join(f'{e:.3g}' for e in errs)} (limit 2e-2)")
        if max(errs) > 2e-2:
            print("the source's kernels disagree with the plain version", file=sys.stderr)
            return 1

    def kernel(n, which):
        def call():
            use(n)
            if which == "dq":
                attn.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
            else:
                attn.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        return call

    fns = {(n, w): kernel(n, w) for n in names for w in ("dq", "dkv")}
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {key: [] for key in fns}
    for _ in range(31):
        for key, fn in fns.items():
            flush.zero_()
            torch.cuda._sleep(1_000_000)  # the host enqueues the call while the card spins
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times[key].append(e0.elapsed_time(e1))
    print("device ms, median of 31, L2 flushed, B8 T1024 H8 D128 bf16 causal:")
    for n in names:
        print(f"  {n:12s} dQ {np.median(times[(n, 'dq')]):.4f}  dK/dV {np.median(times[(n, 'dkv')]):.4f}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    against = None
    if "--against" in args:
        i = args.index("--against")
        against = os.path.abspath(args[i + 1])
        del args[i:i + 2]
    chosen = args or list(VARIANTS)
    unknown = [n for n in chosen if n not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: {list(VARIANTS)}")
    sys.exit(main(chosen, against))
