#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cluster_anywhere_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of the repo; needs one CUDA card and nvcc

Phases, each of which raises (and the script exits non-zero) on failure:
  1. build the flash-attention forward (ops/csrc/flash_fwd.cu) and backward
     (ops/csrc/flash_bwd.cu: the dQ and dK/dV kernels), one nvcc each, both
     started together; show with cuobjdump that the backward's bf16 Hopper
     instances run wgmma (HGMMA) on tiles loaded by TMA (UTMALDG); hold
     each kernel to its plain PyTorch version on the card (causal and not,
     with and without pad, a pad across a 128-key block, T != T_kv, ragged
     T, fp32 and bf16, an LSE cotangent, the flagship prefill and training
     shapes), and two backward calls on the same inputs to the same bits;
  2. time the kernels, their plain versions and torch's
     scaled_dot_product_attention forward and backward (the yardsticks; the
     port never calls them) at the flagship prefill and training shapes,
     beside the card's bound for the same work; device time, with the
     host's launch hidden behind a spin kernel (and, for comparison, with
     the launch in the time); the backward kernels and SDPA's backward
     in one loop, so that their ratio comes from the same clocks, which
     nvidia-smi samples before and after;
  3. batch generation at the flagship width: 8 prompts of 128-512 tokens,
     32 greedy tokens, against the same call with the plain attention;
  4. a ContinuousLLMServer at the flagship width answering 8 concurrent
     requests that share a system prefix (prefix-cache miss and hits);
  5. training at the flagship width and depth: entry()'s forward step, then
     make_train_step (AdamW) on a fixed batch of 8 x 1024 tokens, 1 warm-up
     step and 10 timed steps, 3 more under torch.profiler (device time by
     kernel group, idle share) after which serving must see the trained
     weights, and one step's loss and gradients against the same step
     with the plain attention.
The kernels' launch counts are zeroed just before phases 3-5 (the main
path) and read just after: serving launches no backward kernel, and every
training step launches 8 of each kernel.  Prints a `kernels` JSON line, the
card's name and power limit, and as its last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

B, T, N_NEW = 8, 512, 32  # serving: prompts, prompt length, new tokens
TRAIN_B, TRAIN_T, TRAIN_STEPS = 8, 1024, 10  # bench.py's training batch
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core FLOP/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(*a):
    print(*a, flush=True)


def prompt_lens():
    """Real prompt lengths spread over 128..512, one per batch row."""
    return np.linspace(128, T, B).astype(np.int64)


def flagship():
    from cluster_anywhere_tpu_torch.entry import flagship_cfg

    return flagship_cfg()


def flagship_prefill_inputs(torch, gen):
    """q, k, v, pad as the flagship prefill gives the kernel: bf16
    [8, 512, 8, 128], with the rows left-padded to 128..512 real tokens."""
    cfg = flagship()
    shape = (B, T, cfg.n_heads, cfg.d_head)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(3))
    pad = torch.from_numpy(T - prompt_lens()).cuda()
    return q, k, v, pad


# ----------------------------------------------------------------- phase 1


def phase_build():
    """Both kernel sources, one nvcc each, started together."""
    from cluster_anywhere_tpu_torch.ops import _build

    libs, errors = {}, {}

    def build(name):
        t0 = time.perf_counter()
        try:
            libs[name] = (_build.build(name), time.perf_counter() - t0)
        except Exception as e:  # reported below; fails the phase
            errors[name] = e

    threads = [threading.Thread(target=build, args=(n,)) for n in ("flash_fwd", "flash_bwd")]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    check(not errors, f"kernel build failed: {errors}")
    for name, (lib, secs) in libs.items():
        log(f"[build] {name}.cu -> {lib.name} in {secs:.1f} s")
        for line in (lib.parent / "build.log").read_text().splitlines():
            if "registers" in line or "spill" in line and " 0 bytes spill" not in line:
                log("[build]", line.strip())
    check_hopper_sass(_build, libs["flash_bwd"][0])


def sass_functions(sass):
    """{mangled kernel name: its SASS lines} from `cuobjdump -sass`."""
    funcs, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return funcs


def check_hopper_sass(_build, lib):
    """The backward's bf16 instances at D 64 and 128 issue wgmma (HGMMA) on
    tiles that TMA loads (UTMALDG), and no mma.sync instance is left at
    those D."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, timeout=120)
    check(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    funcs = sass_functions(out.stdout)
    for kernel in ("bwd_dq_bf16_wgmma", "bwd_dkv_bf16_wgmma"):
        for d in (64, 128):
            body = next((v for k, v in funcs.items() if kernel in k and f"ILi{d}E" in k), None)
            check(body is not None, f"{kernel}<{d}> is not in {lib.name}")
            n_hgmma = sum("HGMMA" in line for line in body)
            n_tma = sum("UTMALDG" in line for line in body)
            log(f"[sass] {kernel}<{d}>: {n_hgmma} HGMMA, {n_tma} UTMALDG instructions")
            check(n_hgmma > 0 and n_tma > 0, f"{kernel}<{d}> has no wgmma or no TMA load in its SASS")
    stale = [k for k in funcs if "_bf16_mma" in k and ("ILi64E" in k or "ILi128E" in k)]
    check(not stale, f"mma.sync bf16 backward instances left at D 64/128: {stale}")


def phase_kernel_check(torch, attn, gen):
    cases = [
        # (B, T, T_kv, H, D, dtype, causal, padded)
        (2, 200, 200, 3, 64, "float32", True, True),
        (2, 200, 200, 3, 128, "float32", False, False),
        (2, 64, 130, 2, 32, "float32", True, True),
        (2, 130, 64, 2, 16, "float32", False, True),
        (2, 200, 200, 3, 128, "bfloat16", True, True),
        (2, 200, 200, 3, 64, "bfloat16", False, False),
        (2, 77, 150, 4, 32, "bfloat16", True, True),
        (2, 150, 77, 4, 16, "bfloat16", False, True),
        (2, 200, 200, 3, 128, "bfloat16", True, False),
    ]
    tol = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 1e-3)}

    def compare(name, q, k, v, causal, pad, dtype):
        o, lse = attn.flash_attention(q, k, v, causal=causal, pad=pad, return_lse=True)
        torch.cuda.synchronize()
        po, plse = attn._flash_attention_plain(q, k, v, causal=causal, scale=q.shape[-1] ** -0.5,
                                               pad=pad)
        err_o = (o.float() - po.float()).abs().max().item()
        real = plse > attn.NEG_INF / 2
        err_lse = (lse - plse).abs()[real].max().item()
        masked_ok = bool((lse[~real] == attn.NEG_INF).all().item())
        ok = err_o <= tol[dtype][0] and err_lse <= tol[dtype][1] and masked_ok
        log(f"[kernel] {name} {dtype}: O err {err_o:.3g} (tol {tol[dtype][0]}), "
            f"LSE err {err_lse:.3g} (tol {tol[dtype][1]}), masked rows LSE=-1e30 {masked_ok}")
        check(ok, f"flash_fwd disagrees with its plain version on {name} {dtype}")
        return err_o

    for b, t, t_kv, h, d, dtype, causal, padded in cases:
        dt = getattr(torch, dtype)
        q = torch.randn((b, t, h, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, t_kv, h, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, t_kv, h, d), generator=gen, device="cuda").to(dt)
        pad = torch.tensor([min(t, t_kv) // 3, 0], device="cuda") if padded else None
        compare(f"B{b} T{t} Tkv{t_kv} H{h} D{d} causal={causal} pad={padded}",
                q, k, v, causal, pad, dtype)
    q, k, v, pad = flagship_prefill_inputs(torch, gen)
    return compare("flagship prefill B8 T512 H8 D128 causal pad", q, k, v, True, pad, "bfloat16")


# ----------------------------------------------------------------- phase 2


SPIN_CYCLES = 2_000_000  # about 1 ms of the card's clock: longer than any timed call takes to launch


def time_cold(torch, fn, reps=31, warmup_s=1.0, hide_launch=True):
    """Median device ms of fn() over `reps` calls, L2 flushed before each
    (the inputs fit in the 50 MB L2; a prefill finds them in device
    memory).  A second of the same loop first brings the card's clocks up:
    the first cold launches after idle time run up to 1.5x slower."""
    return time_cold_in_turn(torch, {"fn": fn}, reps, warmup_s, hide_launch)["fn"]


def time_cold_in_turn(torch, fns, reps=31, warmup_s=1.0, hide_launch=True):
    """time_cold of each function of `fns` (name -> fn), taken in turn in
    every repetition, so that each median comes from the same clocks.  With
    hide_launch, a spin kernel runs between the flush and the timed call,
    so that the host has enqueued the call before the card reaches it and
    the events time the card's work alone; without it, the time includes
    whatever part of the host's launch outlasts the flush."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    t_end = time.perf_counter() + warmup_s
    while time.perf_counter() < t_end:
        for fn in fns.values():
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(reps):
        for name, fn in fns.items():
            flush.zero_()
            if hide_launch:
                torch.cuda._sleep(SPIN_CYCLES)
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            torch.cuda.synchronize()
            times[name].append(e0.elapsed_time(e1))
    return {name: float(np.median(t)) for name, t in times.items()}


def gpu_clocks():
    """The SM clock and its maximum, as nvidia-smi reads them now."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return smi.stdout.strip() if smi.returncode == 0 else f"not read ({smi.stderr.strip()})"


def phase_kernel_timing(torch, attn, gen):
    import torch.nn.functional as F

    q, k, v, pad = flagship_prefill_inputs(torch, gen)
    h, d = q.shape[2], q.shape[3]
    ms = time_cold(torch, lambda: attn.flash_attention(q, k, v, causal=True, pad=pad))
    launch_ms = time_cold(torch, lambda: attn.flash_attention(q, k, v, causal=True, pad=pad),
                          hide_launch=False)
    plain_ms = time_cold(torch, lambda: attn._flash_attention_plain(
        q, k, v, causal=True, scale=d ** -0.5, pad=pad), reps=7)
    keys = torch.arange(T, device="cuda")
    mask = (keys[None, :] <= keys[:, None])[None, None] & (keys[None, None, None, :] >= pad[:, None, None, None])
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_cold(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask))
    # bound: what the output depends on read once and each output written
    # once, over HBM; the products the data needs, over the bf16 tensor-core
    # peak.  The rows below pad[b] are masked for every query and are fully
    # masked queries (O = 0 and LSE = -1e30 whatever q, k, v hold there), so
    # q, k and v count only the live rows, as the causal pairs do; O and LSE
    # are written in full.
    live = T - pad.cpu().numpy()
    row_bytes = h * d * q.element_size()
    nbytes = (3 * float(live.sum()) * row_bytes + q.numel() * q.element_size() + B * h * T * 4
              + pad.numel() * pad.element_size())
    flops = 4 * d * h * float(np.sum(live * (live + 1) / 2))
    t_bytes, t_flops = nbytes / HBM_BYTES_S * 1e3, flops / BF16_FLOPS * 1e3
    bound_ms, bound_by = max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"
    log(f"[timing] flash_fwd at B8 T512 H8 D128 bf16 causal+pad (L2 flushed, median, device time): "
        f"kernel {ms:.4f} ms (with the host's launch: {launch_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def flagship_train_attention_inputs(torch, gen):
    """q, k, v, dO as a flagship training step gives the backward kernels:
    bf16 [8, 1024, 8, 128] (K/V after the GQA repeat), causal, no pad."""
    cfg = flagship()
    shape = (TRAIN_B, TRAIN_T, cfg.n_heads, cfg.d_head)
    return tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(4))


# The backward kernels against _flash_bwd_plain, row by row: each gradient
# row (one query or key of one head, D values) is held to its own norm,
#   ||got_r - want_r|| / max(||want_r||, 0.1 * RMS over rows of ||want_r||).
# Under causal the rows differ in size by 10-100x (the first keys are seen by
# every query, the last by a few), so a limit relative to the largest element
# would let a fault on the small late rows pass; relative to each row's own
# norm such a fault reads as O(1).  Rows below the floor are held in absolute
# terms: there a sound kernel's error follows the size of the terms summed,
# not of their sum (dQ of a row that sees one key is zero by cancellation,
# and an fp32 kernel leaves ~1e-6 of it; pad rows are zero).  Limits: fp32 1e-4 (full fp32 in both; summation order differs);
# bf16 2e-2 (the gradients are rounded to bf16, 2^-8 relative, and the kernels
# round P and dS to bf16 before their products, as FA2 does: a sound kernel
# reads about 5e-3 at the flagship shape, a skipped or unwritten tile ~1).
BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def bwd_row_errs(got, want):
    """The row error above, for each of (dQ, dK, dV)."""
    errs = []
    for g, w in zip(got, want):
        diff, norm = (g.float() - w.float()).norm(dim=-1), w.float().norm(dim=-1)
        floor = 0.1 * norm.square().mean().sqrt()
        errs.append((diff / norm.clamp(min=floor.item())).max().item())
    return errs


def phase_bwd_check(torch, attn, gen):
    cases = [
        # (B, T, T_kv, H, D, dtype, causal, pad of batch row 0, LSE cotangent)
        (2, 200, 200, 3, 64, "float32", True, 66, False),
        (2, 200, 200, 3, 128, "float32", False, None, True),
        (2, 64, 130, 2, 32, "float32", True, 21, False),
        (2, 130, 64, 2, 16, "float32", False, 21, True),
        (2, 200, 200, 3, 128, "bfloat16", True, 66, False),
        (2, 200, 200, 3, 64, "bfloat16", False, None, True),
        (2, 77, 150, 4, 32, "bfloat16", True, 25, True),
        (2, 150, 77, 4, 16, "bfloat16", False, 25, False),
        # across the Hopper kernels' tiles: a pad across the first 128-key
        # block, ragged 520-row and 520-key edges
        (2, 333, 333, 3, 128, "bfloat16", True, 150, False),
        (2, 333, 333, 3, 64, "float32", True, 150, True),
        (2, 96, 520, 3, 64, "bfloat16", False, None, True),
        (2, 520, 96, 3, 128, "bfloat16", True, None, False),
    ]

    def compare(name, q, k, v, do, causal, pad, dtype, with_dlse):
        o, lse = attn.flash_attention(q, k, v, causal=causal, pad=pad, return_lse=True)
        dlse = torch.randn(lse.shape, generator=gen, device="cuda") if with_dlse else None
        scale = q.shape[-1] ** -0.5
        got = attn.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale, pad=pad,
                                       dlse=dlse)
        torch.cuda.synchronize()
        want = attn._flash_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale, pad=pad,
                                     dlse=dlse)
        abs_errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
        rel = bwd_row_errs(got, want)
        ok = max(rel) <= BWD_TOL[dtype] and all(g.dtype == q.dtype for g in got)
        log(f"[bwd] {name} {dtype} dlse={with_dlse}: dQ/dK/dV row error "
            f"{'/'.join(f'{r:.3g}' for r in rel)} (tol {BWD_TOL[dtype]}), max abs err "
            f"{'/'.join(f'{e:.3g}' for e in abs_errs)}")
        check(ok, f"flash backward disagrees with its plain version on {name} {dtype}")
        return got, abs_errs

    for b, t, t_kv, h, d, dtype, causal, pad0, with_dlse in cases:
        dt = getattr(torch, dtype)
        q = torch.randn((b, t, h, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, t_kv, h, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, t_kv, h, d), generator=gen, device="cuda").to(dt)
        do = torch.randn((b, t, h, d), generator=gen, device="cuda").to(dt)
        pad = None if pad0 is None else torch.tensor([pad0, 0], device="cuda")
        compare(f"B{b} T{t} Tkv{t_kv} H{h} D{d} causal={causal} pad={pad0}",
                q, k, v, do, causal, pad, dtype, with_dlse)
    q, k, v, do = flagship_train_attention_inputs(torch, gen)
    got, errs = compare("flagship training B8 T1024 H8 D128 causal", q, k, v, do, True, None,
                        "bfloat16", False)
    o, lse = attn.flash_attention(q, k, v, causal=True, return_lse=True)
    again = attn.flash_attention_bwd(q, k, v, o, lse, do, causal=True, scale=q.shape[-1] ** -0.5)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"[bwd] two backward calls on the flagship inputs give the same bits: {same}")
    check(same, "the backward kernels are not bit-reproducible")
    return errs[0], max(errs[1:])


def phase_bwd_timing(torch, attn, gen):
    """The backward at the flagship training shape, L2 flushed before each
    call: each kernel alone (delta given), the whole backward (delta
    reduction + both kernels) and SDPA's backward, in turn in one loop;
    then the plain version."""
    import torch.nn.functional as F

    q, k, v, do = flagship_train_attention_inputs(torch, gen)
    b, t, h, d = q.shape
    scale = d ** -0.5
    o, lse = attn.flash_attention(q, k, v, causal=True, return_lse=True)
    delta = attn._bwd_delta(o, do)
    kw = dict(causal=True, scale=scale)
    qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    doh = do.transpose(1, 2)
    fns = {
        "dq": lambda: attn.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
        "dkv": lambda: attn.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
        "whole": lambda: attn.flash_attention_bwd(q, k, v, o, lse, do, **kw),
        "sdpa": lambda: torch.autograd.grad(out, (qh, kh, vh), doh, retain_graph=True),
    }
    ms = time_cold_in_turn(torch, fns)
    launch = time_cold_in_turn(torch, fns, hide_launch=False)
    plain_ms = time_cold(torch, lambda: attn._flash_bwd_plain(q, k, v, o, lse, do, **kw), reps=7)
    # bound: each input read once and each output written once, over HBM;
    # the products over the causal (query, key) pairs, over the bf16
    # tensor-core peak.  dQ needs S = Q K^T, dP = dO V^T and dS K; dK/dV
    # needs S, dP, P^T dO and dS^T Q; the whole backward 5 distinct products.
    pairs = b * h * t * (t + 1) / 2
    row = q.numel() * q.element_size()  # one [B, T, H, D] bf16 tensor
    stats = b * h * t * 4  # one [B, H, T] fp32 tensor

    def flops(n_products):
        return n_products * 2 * d * pairs

    def bound(n_products, n_in, n_stats, n_out):
        t_flops = flops(n_products) / BF16_FLOPS * 1e3
        t_bytes = ((n_in + n_out) * row + n_stats * stats) / HBM_BYTES_S * 1e3
        return max(t_flops, t_bytes), "bytes" if t_bytes >= t_flops else "operations", t_bytes

    def tflops(n_products, t_ms):
        return flops(n_products) / t_ms / 1e9

    dq_b = bound(3, 4, 2, 1)      # q, k, v, dO, lse, delta -> dQ
    dkv_b = bound(4, 4, 2, 2)     # q, k, v, dO, lse, delta -> dK, dV
    all_b = bound(5, 5, 1, 3)     # q, k, v, O, dO, lse -> dQ, dK, dV
    log(f"[timing] flash backward at B8 T1024 H8 D128 bf16 causal (L2 flushed, median of 31, "
        f"device time, kernels and sdpa in turn in one loop): "
        f"dQ kernel {ms['dq']:.4f} ms, {tflops(3, ms['dq']):.1f} TFLOP/s of its 3 products "
        f"(bound {dq_b[0]:.4f} by {dq_b[1]}); dK/dV kernel {ms['dkv']:.4f} ms, "
        f"{tflops(4, ms['dkv']):.1f} TFLOP/s of its 4 products (bound {dkv_b[0]:.4f} by "
        f"{dkv_b[1]}); sum {ms['dq'] + ms['dkv']:.4f} ms; whole backward with the delta reduction "
        f"{ms['whole']:.4f} ms, {tflops(5, ms['whole']):.1f} TFLOP/s of the 5 products, against a "
        f"bound of {all_b[0]:.4f} ms by {all_b[1]} ({flops(5) / 1e9:.2f} GFLOP; {all_b[2]:.4f} ms "
        f"for {(8 * row + stats) / 1e6:.1f} MB); sdpa backward {ms['sdpa']:.4f} ms; whole / sdpa "
        f"{ms['whole'] / ms['sdpa']:.3f}x, kernels / sdpa {(ms['dq'] + ms['dkv']) / ms['sdpa']:.3f}x; "
        f"plain {plain_ms:.4f} ms")
    log(f"[timing] the same loop with the host's launch in the time: dQ {launch['dq']:.4f} "
        f"ms, dK/dV {launch['dkv']:.4f} ms, whole backward {launch['whole']:.4f} ms, sdpa backward "
        f"{launch['sdpa']:.4f} ms; whole / sdpa {launch['whole'] / launch['sdpa']:.3f}x")
    common = dict(plain_ms=plain_ms, library_ms=ms["sdpa"])
    return (dict(ms=ms["dq"], bound_ms=dq_b[0], bound_by=dq_b[1], **common),
            dict(ms=ms["dkv"], bound_ms=dkv_b[0], bound_by=dkv_b[1], **common))


# ----------------------------------------------------------------- phases 3-4


def phase_generate(torch):
    from cluster_anywhere_tpu_torch.models.generate import generate, prefill
    from cluster_anywhere_tpu_torch.models.transformer import init_params

    cfg = flagship()
    model = init_params(cfg, 0, device="cuda")
    lens = prompt_lens()
    rng = np.random.default_rng(0)
    ids = rng.integers(3, cfg.vocab_size, (B, T))
    for i, n in enumerate(lens):
        ids[i, : T - n] = 0
    ids_t, lens_t = torch.from_numpy(ids).cuda(), torch.from_numpy(lens).cuda()
    generate(model, ids_t, cfg=cfg, max_new_tokens=2, prompt_lens=lens_t)  # warm-up
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            prefill(model, ids_t, cfg, T + N_NEW, pad=T - lens_t)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) / 3 * 1e3
    return cfg, model, ids_t, lens_t, prefill_ms


def run_generate(torch, attn, cfg, model, ids_t, lens_t, prefill_ms):
    from cluster_anywhere_tpu_torch.models.generate import generate

    before = attn.flash_attention.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(model, ids_t, cfg=cfg, max_new_tokens=N_NEW, prompt_lens=lens_t)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    launches = attn.flash_attention.launches - before
    check(tuple(out.shape) == (B, N_NEW), f"generate returned {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "generated ids out of the vocab")
    check(launches == cfg.n_layers, f"generate launched flash_fwd {launches} times, want {cfg.n_layers}")
    decode_tok_s = B * (N_NEW - 1) / max((total_ms - prefill_ms) / 1e3, 1e-9)
    log(f"[generate] flagship B{B} prompts {T} (real {prompt_lens().tolist()}) +{N_NEW} greedy: "
        f"prefill {prefill_ms:.2f} ms, total {total_ms:.2f} ms, decode {decode_tok_s:.1f} tok/s, "
        f"flash_fwd launches {launches}")
    return out


def plain_attention(attn):
    """flash_attention with the plain version in place of the kernels
    (differentiable by autograd through its torch ops)."""
    def plain(q, k, v, *, causal=True, scale=None, pad=None, return_lse=False):
        o, lse = attn._flash_attention_plain(
            q, k, v, causal=causal, scale=q.shape[-1] ** -0.5 if scale is None else scale, pad=pad)
        return (o, lse) if return_lse else o

    return plain


def compare_with_plain_attention(torch, attn, cfg, model, ids_t, lens_t, out):
    """The same generate with the attention forced to the plain version."""
    from cluster_anywhere_tpu_torch.models.generate import generate, prefill

    kernel = attn.flash_attention

    plain = plain_attention(attn)
    with torch.no_grad():
        logits_k, _ = prefill(model, ids_t, cfg, T + 1, pad=T - lens_t)
        attn.flash_attention = plain
        try:
            ref = generate(model, ids_t, cfg=cfg, max_new_tokens=N_NEW, prompt_lens=lens_t)
            logits_p, _ = prefill(model, ids_t, cfg, T + 1, pad=T - lens_t)
        finally:
            attn.flash_attention = kernel
    top2 = logits_p.topk(2, dim=-1).values
    log(f"[generate] first-token logits, kernel vs plain attention: max |diff| "
        f"{(logits_k - logits_p).abs().max().item():.4g}; plain top-2 gap per row "
        f"{[round(g, 4) for g in (top2[:, 0] - top2[:, 1]).tolist()]}")
    check(torch.equal(out[:, 0], ref[:, 0]),
          f"first tokens differ from the plain attention: {out[:, 0].tolist()} vs {ref[:, 0].tolist()}")
    rate = (out[:, 1:] == ref[:, 1:]).float().mean().item()
    log(f"[generate] vs plain attention: first tokens equal, later tokens match rate {rate:.4f} "
        f"(bf16 may flip near-ties, after which a row's continuation diverges)")


def phase_server(torch, attn):
    from cluster_anywhere_tpu_torch.llm import ContinuousLLMServer, ModelSpec, ProcessorConfig

    fl = flagship()
    overrides = {f: getattr(fl, f) for f in ("d_model", "n_layers", "n_heads", "n_kv_heads",
                                             "d_head", "d_ff", "max_seq_len", "dtype")}
    cfg = ProcessorConfig(model=ModelSpec(preset="custom", config_overrides=overrides),
                          max_prompt_len=T, max_new_tokens=N_NEW, prefix_cache_entries=8)
    before = attn.flash_attention.launches
    srv = ContinuousLLMServer(cfg, slots=8, device="cuda")
    try:
        system = ("You are the operations assistant of a cluster that schedules tasks, actors "
                  "and placement groups over many nodes. Answer in one short paragraph, name the "
                  "component you rely on, and never invent metrics you were not given. When a "
                  "node is draining, say which work moves and where. When an object is lost, "
                  "explain lineage reconstruction. When a request is shed, cite the admission "
                  "policy. Keep answers under fifty words. ")
        users = [f"Q{i}: why is node {i} slow?" for i in range(B)]
        ttft, tokens, errors = [None] * B, [None] * B, []
        t_start = time.perf_counter()

        def call(i):
            try:
                t0 = time.perf_counter()
                toks = []
                for item in srv.stream({"prompt": system + users[i]}):
                    if not toks:
                        ttft[i] = time.perf_counter() - t0
                    toks.append(item["token_id"])
                tokens[i] = toks
            except Exception as e:  # reported below; fails the phase
                errors.append(repr(e))

        threads = [threading.Thread(target=call, args=(i,)) for i in range(B)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        wall = time.perf_counter() - t_start
        check(not any(th.is_alive() for th in threads), "a server request did not finish in 300 s")
        check(not errors, f"server requests failed: {errors}")
        n_tok = [len(t) for t in tokens]
        check(all(n == N_NEW for n in n_tok), f"requests answered {n_tok} tokens, want {N_NEW}")
        stats = dict(srv.cb.stats)
        check(stats["prefix_hits"] >= 1, f"no prefix-cache hit: {stats}")
        srv.check_health()
        launches = attn.flash_attention.launches - before
        check(launches >= 1, "the server never launched flash_fwd")
        prompt_len = len(srv.tok.encode(system + users[0]))
        log(f"[server] 8 concurrent requests, prompts {prompt_len} tokens sharing a "
            f"{len(system)}-byte system prefix, {N_NEW} tokens each: TTFT p50 "
            f"{np.median(ttft) * 1e3:.1f} ms, max {max(ttft) * 1e3:.1f} ms; "
            f"{sum(n_tok) / wall:.1f} tok/s over {wall:.2f} s; stats {stats}; "
            f"flash_fwd launches {launches}")
    finally:
        srv.close()


# ----------------------------------------------------------------- phase 5


def model_flops_per_step(cfg, b, t, causal_discount=False):
    """bench.py's count (model_flops_per_step): 3x the forward's matmul
    FLOPs (backward ~= 2x forward), the attention term halved under the
    causal discount."""
    e, h, kv, d = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    f, L, V = cfg.d_ff, cfg.n_layers, cfg.vocab_size
    per_tok_layer = 2 * (e * h * d + 2 * e * kv * d + h * d * e + 3 * e * f)
    attn_per_seq_layer = 4 * t * t * d * h * (0.5 if causal_discount else 1.0)
    fwd = b * t * per_tok_layer * L + b * attn_per_seq_layer * L + b * t * 2 * e * V
    return 3 * fwd


def train_batch(torch, cfg):
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_T + 1))
    return {"ids": torch.from_numpy(ids).cuda()}


def launch_counts(attn):
    return (attn.flash_attention.launches, attn.flash_bwd_dq.launches,
            attn.flash_bwd_dkv.launches)


def phase_train(torch, attn):
    """make_train_step at the flagship on a fixed batch: 1 warm-up step,
    then TRAIN_STEPS timed steps; every step launches each kernel once per
    layer."""
    from cluster_anywhere_tpu_torch.entry import entry
    from cluster_anywhere_tpu_torch.models import make_train_step

    fn, args = entry()  # the forward step at ids (4, 1024), as __graft_entry__.entry
    logits = fn(*args)
    check(tuple(logits.shape) == (4, 1024, 32000) and bool(torch.isfinite(logits).all()),
          f"entry() forward gave {tuple(logits.shape)} {logits.dtype}, or non-finite logits")
    log(f"[entry] forward step on ids (4, 1024): logits {tuple(logits.shape)} {logits.dtype}, finite")
    del fn, args, logits

    cfg = flagship()
    step, init_state = make_train_step(cfg)
    model, opt = init_state(0)
    batch = train_batch(torch, cfg)
    want = (cfg.n_layers,) * 3
    per_step, losses = [], []

    def run():
        before = launch_counts(attn)
        _, _, loss = step(model, opt, batch)
        per_step.append(tuple(a - b for a, b in zip(launch_counts(attn), before)))
        losses.append(loss)

    run()  # warm-up: allocator, cuBLAS handles, optimizer state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        run()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / TRAIN_STEPS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [x.item() for x in losses]
    flops = model_flops_per_step(cfg, TRAIN_B, TRAIN_T, causal_discount=True)
    tok_s = TRAIN_B * TRAIN_T / step_s
    mfu = flops / step_s / BF16_FLOPS
    log(f"[train] flagship B{TRAIN_B} T{TRAIN_T}, AdamW lr 3e-4: step {step_s * 1e3:.2f} ms "
        f"(host clock over {TRAIN_STEPS} steps ending in synchronize), {tok_s:.0f} tok/s, "
        f"MFU {mfu * 100:.2f}% of 989 TFLOP/s ({flops / 1e12:.2f} TFLOP/step, causal-discounted), "
        f"peak memory {peak_gb:.2f} GB; loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
        f"{len(losses)} steps; launches per step (fwd, dQ, dK/dV) {sorted(set(per_step))}")
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall from step 1 to step {len(losses)}: {losses}")
    check(all(c == want for c in per_step),
          f"a training step launched (fwd, dQ, dK/dV) {per_step}, want {want} each")
    # the serving copy (cast here, after the peak memory is read) follows
    # the profiled steps of the card's (multi-tensor) AdamW
    served = model.compute_weights()["blocks"][0]["wq"].clone()
    profile_steps(torch, lambda: step(model, opt, batch), step_s * 1e3)
    now = model.compute_weights()["blocks"][0]["wq"]
    fresh = torch.equal(now, model.blocks[0].wq.detach().to(cfg.dtype))
    log(f"[train] serving weights after the profiled steps are the trained ones: {fresh}")
    check(fresh and not torch.equal(now, served),
          "compute_weights serves weights from before the optimizer steps")


KERNEL_GROUPS = (  # (group, substrings of the kernel names it takes), first match wins
    ("flash attention (this repo)", ("flash_fwd", "bwd_dq", "bwd_dkv")),
    ("matmul (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "sm90_")),
    ("AdamW (multi_tensor_apply)", ("multi_tensor", "adam")),
    ("other (elementwise, reductions, copies)", ("",)),
)


def profile_steps(torch, fn, step_ms, n=3):
    """Device time of n steps by kernel group, from torch.profiler.  The
    idle share is read two ways: the unprofiled step (`step_ms`, host clock)
    less the kernels' busy time, and the gaps on the device timeline of the
    profiled steps, first kernel start to last kernel end, which the
    profiler's own host overhead widens."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()

    def is_kernel(e):  # kernels, not the ranges user annotations span
        return (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False))

    kernels = [e for e in prof.key_averages() if is_kernel(e) and e.self_device_time_total > 0]
    if not kernels:
        log("[profile] torch.profiler recorded no device time on this machine: not measured")
        return
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events() if is_kernel(e))
    covered, reach = 0.0, spans[0][0]
    for a, b in spans:  # the union of the kernels' intervals, in us
        covered += max(0.0, b - max(a, reach))
        reach = max(reach, b)
    window = reach - spans[0][0]
    groups = {g: 0.0 for g, _ in KERNEL_GROUPS}
    for e in kernels:
        name = e.key.lower()
        group = next(g for g, keys in KERNEL_GROUPS if any(k in name for k in keys))
        groups[group] += e.self_device_time_total / 1e3 / n
    log(f"[profile] {n} training steps: device busy {busy_ms:.2f} ms a step; idle share of the "
        f"unprofiled step ({step_ms:.2f} ms) {max(0.0, 1 - busy_ms / step_ms) * 100:.1f}%; gaps on "
        f"the device timeline of the profiled steps {(1 - covered / window) * 100:.1f}% of "
        f"{window / 1e3 / n:.2f} ms a step; device ms a step by group: "
        + "; ".join(f"{g} {ms:.2f}" for g, ms in groups.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3 / n:8.3f} ms/step  "
            f"{e.count / n:5.0f} launches/step  {e.key[:110]}")


# one step's loss and gradients, kernels against plain attention: both run
# bf16 activations and differ in where attention rounds (the kernels keep P
# as hi + lo bf16 parts in P.V, round P and dS to bf16 in the backward, and
# sum in another order), 2^-8 relative a bf16 rounding, carried through 8
# layers of bf16 products.  A wrong kernel (a dropped term, a mis-mapped
# tile) moves a gradient by O(1) of its norm.  The cosine is printed and not
# held: a relative L2 error r already bounds it below by sqrt(1 - r^2).
TRAIN_GRAD_TOL = dict(loss_rel=1e-3, grad_rel_l2=5e-2)


def compare_train_with_plain_attention(torch, attn):
    """The same loss and gradients on a fresh flagship with the attention
    forced to the plain version (autograd through _flash_attention_plain)."""
    from cluster_anywhere_tpu_torch.models import init_params, make_loss_fn

    cfg = flagship()
    model = init_params(cfg, 1, device="cuda")
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    loss_fn = make_loss_fn(cfg)
    batch = train_batch(torch, cfg)
    kernel = attn.flash_attention

    plain = plain_attention(attn)
    loss_k = loss_fn(model, batch)
    grads_k = torch.autograd.grad(loss_k, params)
    attn.flash_attention = plain
    try:
        loss_p = loss_fn(model, batch)
        grads_p = torch.autograd.grad(loss_p, params)
    finally:
        attn.flash_attention = kernel
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    worst_rel, worst_cos = (0.0, ""), (1.0, "")
    for name, gk, gp in zip(names, grads_k, grads_p):
        gk, gp = gk.double(), gp.double()
        rel = ((gk - gp).norm() / gp.norm()).item()
        cos = (gk.flatten() @ gp.flatten() / (gk.norm() * gp.norm())).item()
        worst_rel = max(worst_rel, (rel, name))
        worst_cos = min(worst_cos, (cos, name))
    log(f"[train] one step, kernels vs plain attention: loss {loss_k.item():.6f} vs "
        f"{loss_p.item():.6f} (relative {loss_rel:.3g}); worst per-parameter gradient relative "
        f"L2 error {worst_rel[0]:.4g} ({worst_rel[1]}), lowest cosine {worst_cos[0]:.6f} "
        f"({worst_cos[1]}); tolerances {TRAIN_GRAD_TOL}")
    check(loss_rel <= TRAIN_GRAD_TOL["loss_rel"] and worst_rel[0] <= TRAIN_GRAD_TOL["grad_rel_l2"],
          "training gradients with the kernels disagree with the plain attention")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import importlib

    attn = importlib.import_module("cluster_anywhere_tpu_torch.ops.attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    phase_build()
    fwd_err = phase_kernel_check(torch, attn, gen)
    dq_err, dkv_err = phase_bwd_check(torch, attn, gen)
    log(f"[clocks] clocks.sm, clocks.max.sm before the timing phases: {gpu_clocks()}")
    fwd_timing = phase_kernel_timing(torch, attn, gen)
    dq_timing, dkv_timing = phase_bwd_timing(torch, attn, gen)
    log(f"[clocks] clocks.sm, clocks.max.sm after the timing phases: {gpu_clocks()}")
    cfg, model, ids_t, lens_t, prefill_ms = phase_generate(torch)

    # the main path starts here
    attn.flash_attention.launches = attn.flash_bwd_dq.launches = attn.flash_bwd_dkv.launches = 0
    out = run_generate(torch, attn, cfg, model, ids_t, lens_t, prefill_ms)
    phase_server(torch, attn)
    serving = launch_counts(attn)
    phase_train(torch, attn)
    launches = launch_counts(attn)  # ... and ends here
    log(f"[main path] launches (fwd, dQ, dK/dV): serving {serving}, in all {launches}")
    check(serving[0] > 0 and serving[1:] == (0, 0),
          f"serving launched (fwd, dQ, dK/dV) {serving}: want the forward only")
    check(all(n > 0 for n in launches), f"a kernel was not launched on the main path: {launches}")

    compare_with_plain_attention(torch, attn, cfg, model, ids_t, lens_t, out)
    compare_train_with_plain_attention(torch, attn)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [
        {"name": "flash_fwd", "route": "cuda",
         "source": "cluster_anywhere_tpu_torch/ops/csrc/flash_fwd.cu",
         "replaces": "cluster_anywhere_tpu/ops/attention.py:52",
         "launches": launches[0], "max_abs_err": fwd_err, **fwd_timing},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": "cluster_anywhere_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "cluster_anywhere_tpu/ops/attention.py:128",
         "launches": launches[1], "max_abs_err": dq_err, **dq_timing},
        {"name": "flash_bwd_dkv", "route": "cuda",
         "source": "cluster_anywhere_tpu_torch/ops/csrc/flash_bwd.cu",
         "replaces": "cluster_anywhere_tpu/ops/attention.py:192",
         "launches": launches[2], "max_abs_err": dkv_err, **dkv_timing},
    ]}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
