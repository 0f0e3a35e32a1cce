#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cluster_anywhere_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the root of the repo; needs one CUDA card and nvcc

Phases, each of which raises (and the script exits non-zero) on failure:
  1. build the flash-attention forward (ops/csrc/flash_fwd.cu) and backward
     (ops/csrc/flash_bwd.cu: the dQ and dK/dV kernels), one nvcc each, both
     started together; show with cuobjdump that the bf16 Hopper instances
     of all three kernels run wgmma (HGMMA) on tiles loaded by TMA
     (UTMALDG); hold each kernel to its plain PyTorch version on the card
     (causal and not, with and without pad, a pad across a key tile or
     over whole 128-row query blocks, T != T_kv, ragged T, fp32 and bf16,
     an LSE cotangent, the flagship prefill and training shapes; O and the
     gradients also row by row), and two calls of each kernel on the same
     inputs to the same bits;
  2. time the kernels, their plain versions and torch's
     scaled_dot_product_attention forward and backward (the yardsticks; the
     port never calls them) at the flagship prefill and training shapes,
     beside the card's bound for the same work; device time, with the
     host's launch hidden behind a spin kernel (and, for comparison, with
     the launch in the time); each kernel and its SDPA call in one loop, so
     that their ratio comes from the same clocks, which nvidia-smi samples
     before and after;
  3. batch generation at the flagship width: 8 prompts of 128-512 tokens,
     32 greedy tokens, against the same call with the plain attention;
  4. a ContinuousLLMServer at the flagship width answering 8 concurrent
     requests that share a system prefix (prefix-cache miss and hits);
     then (after phase 5, its counts zeroed and read on their own) the
     same 8 requests over HTTP: the port's runtime (ca.init, which must
     detect the GPU itself), Serve on a port the OS picks, and
     build_continuous_llm_deployment with one GPU replica in a process of
     its own; 8 concurrent SSE streams, then 8 JSON POSTs, then the SSE
     streams again on the warm replica, each answer equal
     to the in-process server's or differing only on a near-tie, the
     forward's launches read inside the replica, and no process of the
     session left after shutdown;
  4c. (after 4b, on a session of its own) the Data library: the processor
     cell, build_llm_processor over cad.from_items of 60 prompts with the
     chat template and the server cell's system prefix, its inference in
     one GPU actor that the Data executor starts (60 rows back, each equal
     to the in-process _InferenceWorker's tokens or differing on a
     near-tie, the forward's launches read inside the actor for every
     batch, none in the driver); then the train-data cell, the train
     cell's step fed by cad.from_numpy(ids).iter_torch_batches on the card
     (every batch equal to its rows of ids, step 1's loss equal to the
     host's rows', all three kernels launched);
  5. training at the flagship width and depth: entry()'s forward step, then
     make_train_step (AdamW) on a fixed batch of 8 x 1024 tokens, 1 warm-up
     step and 10 timed steps, 3 more under torch.profiler (device time by
     kernel group, idle share) after which serving must see the trained
     weights, and one step's loss and gradients against the same step
     with the plain attention.
  6. the same three cells on the flagship's mixture-of-experts variant
     (every FFN 4 top-1 experts, capacity factor 1.25, aux weight 0.01,
     all experts on the card): generate-moe, server-moe and train-moe
     (device time with routing and dispatch as a group of their own, no
     MFU: a token visits one expert, so the dense FLOP count misleads).
     The MoE first tokens and gradients are compared with the plain
     attention twice: with each run routing on its own (the share of
     routes that agree is printed) and with the plain run's routes pinned
     to the kernel run's, which is held to the dense limits.
The kernels' launch counts are zeroed just before phases 3-5 (the main
path) and read just after, and again around each MoE cell: serving
launches no backward kernel, and every training step launches 8 of each
kernel; the HTTP and processor cells launch nothing in the driver.
Prints whether pyarrow and pandas import (the Data library needs
neither), a `kernels` JSON line (launches summed over all cells, the
replica's and the processor actor's included), the card's name and power
limit, and as its last line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
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


def moe_flagship():
    """The flagship with every FFN 4 top-1 switch experts, as bench.py's
    MoE step (bench.py:401-404), at the full 8 layers and ep = 1."""
    return dataclasses.replace(flagship(), n_experts=4, capacity_factor=1.25, moe_aux_weight=0.01)


@contextlib.contextmanager
def moe_routes(log, pin=False):
    """Inside, every top-1 MoE route (training's moe_ffn and serving's
    _moe_infer) appends its expert indices to `log`; with pin, the routes
    are instead taken in turn from `log`, the gates from the run's own
    probabilities at those experts."""
    from cluster_anywhere_tpu_torch.models import generate as gen_mod
    from cluster_anywhere_tpu_torch.parallel import moe as moe_mod

    real = moe_mod.top1_route
    replay = iter(list(log))

    def route(logits):
        probs, idx, gate = real(logits)
        if pin:
            idx = next(replay)
            gate = probs.gather(-1, idx[..., None])[..., 0]
        else:
            log.append(idx)
        return probs, idx, gate

    moe_mod.top1_route = gen_mod.top1_route = route
    try:
        yield
    finally:
        moe_mod.top1_route = gen_mod.top1_route = real


def route_agreement(a, b):
    """The share of tokens routed to the same expert in two route logs."""
    same = sum(int((x == y).sum().item()) for x, y in zip(a, b))
    return same / max(1, sum(x.numel() for x in a))


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
    check_hopper_sass(_build, {name: lib for name, (lib, _) in libs.items()})


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


# the bf16 Hopper instances of each library, at D 64 and 128
HOPPER_KERNELS = {"flash_fwd": ("flash_fwd_bf16_wgmma",),
                  "flash_bwd": ("bwd_dq_bf16_wgmma", "bwd_dkv_bf16_wgmma")}


def check_hopper_sass(_build, libs):
    """The bf16 instances at D 64 and 128 of the forward and both backward
    kernels issue wgmma (HGMMA) on tiles that TMA loads (UTMALDG), and no
    mma.sync instance is left at those D in either library."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for name, kernels in HOPPER_KERNELS.items():
        lib = libs[name]
        out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                             timeout=120)
        check(out.returncode == 0, f"cuobjdump failed on {lib.name}: {out.stderr[-2000:]}")
        funcs = sass_functions(out.stdout)
        for kernel in kernels:
            for d in (64, 128):
                body = next((v for k, v in funcs.items() if kernel in k and f"ILi{d}E" in k), None)
                check(body is not None, f"{kernel}<{d}> is not in {lib.name}")
                n_hgmma = sum("HGMMA" in line for line in body)
                n_tma = sum("UTMALDG" in line for line in body)
                # a wait after every wgmma means ptxas serialised the products
                n_wait = sum("WARPGROUP.DEPBAR" in line for line in body)
                log(f"[sass] {kernel}<{d}>: {n_hgmma} HGMMA, {n_tma} UTMALDG, {n_wait} "
                    f"WARPGROUP.DEPBAR instructions")
                check(n_hgmma > 0 and n_tma > 0,
                      f"{kernel}<{d}> has no wgmma or no TMA load in its SASS")
        stale = [k for k in funcs if "_bf16_mma" in k and ("ILi64E" in k or "ILi128E" in k)]
        check(not stale, f"mma.sync bf16 instances left at D 64/128 in {lib.name}: {stale}")


# The kernels against their plain versions, row by row: each row of O, and
# each gradient row of the backward (one query or key of one head, D values),
# is held to its own norm,
#   ||got_r - want_r|| / max(||want_r||, 0.1 * RMS over rows of ||want_r||).
# Under causal the gradient rows differ in size by 10-100x (the first keys
# are seen by every query, the last by a few), so a limit relative to the
# largest element would let a fault on the small late rows pass; relative to
# each row's own norm such a fault reads as O(1).  Rows below the floor are
# held in absolute terms: there a sound kernel's error follows the size of
# the terms summed, not of their sum (dQ of a row that sees one key is zero
# by cancellation, and an fp32 kernel leaves ~1e-6 of it; pad rows are
# zero).  Limits: fp32 1e-4 (full fp32 in both; summation order differs);
# bf16 2e-2 (the outputs are rounded to bf16, 2^-8 relative, and the
# backward rounds P and dS to bf16 before their products, as FA2 does: a
# sound backward reads about 5e-3 at the flagship shape, a skipped or
# unwritten tile ~1).
ROW_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def row_errs(got, want):
    """The row error above, for each pair of (got, want) tensors."""
    errs = []
    for g, w in zip(got, want):
        diff, norm = (g.float() - w.float()).norm(dim=-1), w.float().norm(dim=-1)
        floor = 0.1 * norm.square().mean().sqrt()
        errs.append((diff / norm.clamp(min=floor.item())).max().item())
    return errs


def phase_kernel_check(torch, attn, gen):
    cases = [
        # (B, T, T_kv, H, D, dtype, causal, pad of batch row 0)
        (2, 200, 200, 3, 64, "float32", True, 66),
        (2, 200, 200, 3, 128, "float32", False, None),
        (2, 64, 130, 2, 32, "float32", True, 21),
        (2, 130, 64, 2, 16, "float32", False, 21),
        (2, 200, 200, 3, 128, "bfloat16", True, 66),
        (2, 200, 200, 3, 64, "bfloat16", False, None),
        (2, 77, 150, 4, 32, "bfloat16", True, 25),
        (2, 150, 77, 4, 16, "bfloat16", False, 25),
        (2, 200, 200, 3, 128, "bfloat16", True, None),
        # across the Hopper forward's tiles (128-row query blocks, 64-key
        # K/V tiles): a pad across the first key tile, ragged 520-row and
        # 520-key edges, a pad over two whole query blocks (causal: rows
        # that see no key; not causal: rows that see the keys past the pad),
        # and a block whose second warpgroup has no rows while the first
        # reads 9 key tiles
        (2, 333, 333, 3, 128, "bfloat16", True, 150),
        (2, 333, 333, 3, 64, "bfloat16", True, 150),
        (2, 96, 520, 3, 64, "bfloat16", False, None),
        (2, 96, 520, 3, 128, "bfloat16", False, None),
        (2, 520, 96, 3, 128, "bfloat16", True, None),
        (2, 520, 96, 3, 64, "bfloat16", True, None),
        (2, 400, 400, 3, 128, "bfloat16", True, 300),
        (2, 400, 400, 3, 64, "bfloat16", False, 300),
        (2, 60, 520, 3, 128, "bfloat16", False, None),
        (2, 333, 333, 3, 64, "float32", True, 150),
        (2, 400, 400, 3, 128, "float32", True, 300),
    ]
    tol = {"float32": (1e-4, 1e-5), "bfloat16": (2e-2, 1e-3)}

    def compare(name, q, k, v, causal, pad, dtype):
        o, lse = attn.flash_attention(q, k, v, causal=causal, pad=pad, return_lse=True)
        again = attn.flash_attention(q, k, v, causal=causal, pad=pad, return_lse=True)
        torch.cuda.synchronize()
        same = torch.equal(o, again[0]) and torch.equal(lse, again[1])
        po, plse = attn._flash_attention_plain(q, k, v, causal=causal, scale=q.shape[-1] ** -0.5,
                                               pad=pad)
        err_o = (o.float() - po.float()).abs().max().item()
        real = plse > attn.NEG_INF / 2
        err_lse = (lse - plse).abs()[real].max().item()
        masked_ok = bool((lse[~real] == attn.NEG_INF).all().item())
        row = row_errs((o,), (po,))[0]
        ok = (err_o <= tol[dtype][0] and err_lse <= tol[dtype][1] and masked_ok
              and row <= ROW_TOL[dtype] and same)
        log(f"[kernel] {name} {dtype}: O err {err_o:.3g} (tol {tol[dtype][0]}), "
            f"LSE err {err_lse:.3g} (tol {tol[dtype][1]}), masked rows LSE=-1e30 {masked_ok}, "
            f"O row error {row:.3g} (tol {ROW_TOL[dtype]}), two calls the same bits {same}")
        check(ok, f"flash_fwd disagrees with its plain version on {name} {dtype}")
        return err_o

    for b, t, t_kv, h, d, dtype, causal, pad0 in cases:
        dt = getattr(torch, dtype)
        q = torch.randn((b, t, h, d), generator=gen, device="cuda").to(dt)
        k = torch.randn((b, t_kv, h, d), generator=gen, device="cuda").to(dt)
        v = torch.randn((b, t_kv, h, d), generator=gen, device="cuda").to(dt)
        pad = None if pad0 is None else torch.tensor([pad0, 0], device="cuda")
        compare(f"B{b} T{t} Tkv{t_kv} H{h} D{d} causal={causal} pad={pad0}",
                q, k, v, causal, pad, dtype)
    q, k, v, pad = flagship_prefill_inputs(torch, gen)
    prefill_err = compare("flagship prefill B8 T512 H8 D128 causal pad", q, k, v, True, pad,
                          "bfloat16")
    q, k, v = flagship_train_attention_inputs(torch, gen)[:3]
    train_err = compare("flagship training B8 T1024 H8 D128 causal", q, k, v, True, None,
                        "bfloat16")
    return max(prefill_err, train_err)


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


def bound_ms(nbytes, flops):
    """The least time the card could take: bytes over the HBM rate or the
    products over the bf16 tensor-core peak, whichever is longer; and which."""
    t_bytes, t_flops = nbytes / HBM_BYTES_S * 1e3, flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def phase_kernel_timing(torch, attn, gen):
    """The forward at the flagship prefill shape (causal, pad) and at the
    training shape (causal, LSE returned), each in turn in one loop with
    SDPA's forward on the same inputs, L2 flushed before each call; then the
    plain version.  Returns the prefill's numbers (the kernels line)."""
    import torch.nn.functional as F

    q, k, v, pad = flagship_prefill_inputs(torch, gen)
    h, d = q.shape[2], q.shape[3]
    keys = torch.arange(T, device="cuda")
    mask = (keys[None, :] <= keys[:, None])[None, None] & (keys[None, None, None, :] >= pad[:, None, None, None])
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    fns = {"kernel": lambda: attn.flash_attention(q, k, v, causal=True, pad=pad),
           "sdpa": lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)}
    ms = time_cold_in_turn(torch, fns)
    launch = time_cold_in_turn(torch, fns, hide_launch=False)
    plain_ms = time_cold(torch, lambda: attn._flash_attention_plain(
        q, k, v, causal=True, scale=d ** -0.5, pad=pad), reps=7)
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
    bound, bound_by = bound_ms(nbytes, flops)
    log(f"[timing] flash_fwd at B8 T512 H8 D128 bf16 causal+pad (L2 flushed, median of 31, device "
        f"time, kernel and sdpa in turn in one loop): kernel {ms['kernel']:.4f} ms, sdpa forward "
        f"{ms['sdpa']:.4f} ms, kernel / sdpa {ms['kernel'] / ms['sdpa']:.3f}x; bound {bound:.4f} ms by "
        f"{bound_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), kernel / bound "
        f"{ms['kernel'] / bound:.2f}x; plain {plain_ms:.4f} ms; with the host's launch in the time: "
        f"kernel {launch['kernel']:.4f} ms, sdpa {launch['sdpa']:.4f} ms")

    q, k, v = flagship_train_attention_inputs(torch, gen)[:3]
    b, t = q.shape[:2]
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    fns = {"kernel": lambda: attn.flash_attention(q, k, v, causal=True, return_lse=True),
           "sdpa": lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)}
    with torch.no_grad():
        tms = time_cold_in_turn(torch, fns)
        tlaunch = time_cold_in_turn(torch, fns, hide_launch=False)
        tplain = time_cold(torch, lambda: attn._flash_attention_plain(
            q, k, v, causal=True, scale=d ** -0.5), reps=7)
    # q, k, v read and O written once, LSE written once; the causal pairs' two products
    tbytes = 4 * q.numel() * q.element_size() + b * h * t * 4
    tflops = 4 * d * h * b * t * (t + 1) / 2
    tbound, tbound_by = bound_ms(tbytes, tflops)
    log(f"[timing] flash_fwd at B8 T1024 H8 D128 bf16 causal, LSE returned (the training step's; "
        f"L2 flushed, median of 31, device time, kernel and sdpa in turn in one loop): kernel "
        f"{tms['kernel']:.4f} ms, {tflops / tms['kernel'] / 1e9:.1f} TFLOP/s of the causal products; "
        f"sdpa forward (is_causal) {tms['sdpa']:.4f} ms, kernel / sdpa "
        f"{tms['kernel'] / tms['sdpa']:.3f}x; bound {tbound:.4f} ms by {tbound_by} "
        f"({tbytes / 1e6:.1f} MB, {tflops / 1e9:.2f} GFLOP), kernel / bound "
        f"{tms['kernel'] / tbound:.2f}x; plain {tplain:.4f} ms; with the host's launch in the time: "
        f"kernel {tlaunch['kernel']:.4f} ms, sdpa {tlaunch['sdpa']:.4f} ms")
    return dict(ms=ms["kernel"], plain_ms=plain_ms, library_ms=ms["sdpa"], bound_ms=bound,
                bound_by=bound_by)


def flagship_train_attention_inputs(torch, gen):
    """q, k, v, dO as a flagship training step gives the backward kernels:
    bf16 [8, 1024, 8, 128] (K/V after the GQA repeat), causal, no pad."""
    cfg = flagship()
    shape = (TRAIN_B, TRAIN_T, cfg.n_heads, cfg.d_head)
    return tuple(torch.randn(shape, generator=gen, device="cuda").bfloat16() for _ in range(4))


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
        rel = row_errs(got, want)
        ok = max(rel) <= ROW_TOL[dtype] and all(g.dtype == q.dtype for g in got)
        log(f"[bwd] {name} {dtype} dlse={with_dlse}: dQ/dK/dV row error "
            f"{'/'.join(f'{r:.3g}' for r in rel)} (tol {ROW_TOL[dtype]}), max abs err "
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
        nbytes = (n_in + n_out) * row + n_stats * stats
        return (*bound_ms(nbytes, flops(n_products)), nbytes / HBM_BYTES_S * 1e3)

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


def phase_generate(torch, cfg):
    """The generate cell's model and prompts, the prefill timed (3 calls,
    host clock) and then profiled beside 8 decode steps (device time by
    kernel group and idle share), outside the launch counts."""
    from cluster_anywhere_tpu_torch.models.generate import decode_one, generate, prefill
    from cluster_anywhere_tpu_torch.models.transformer import init_params

    model = init_params(cfg, 0, device="cuda")
    lens = prompt_lens()
    rng = np.random.default_rng(0)
    ids = rng.integers(3, cfg.vocab_size, (B, T))
    for i, n in enumerate(lens):
        ids[i, : T - n] = 0
    ids_t, lens_t = torch.from_numpy(ids).cuda(), torch.from_numpy(lens).cuda()
    generate(model, ids_t, cfg=cfg, max_new_tokens=2, prompt_lens=lens_t)  # warm-up
    pad = T - lens_t
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            _, cache = prefill(model, ids_t, cfg, T + N_NEW, pad=pad)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) / 3 * 1e3
        positions = iter(range(T, T + N_NEW))

        def decode():
            decode_one(model, cache, ids_t[:, -1], next(positions), cfg, pad)

        t0 = time.perf_counter()
        for _ in range(8):
            decode()
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) / 8 * 1e3
        tag = "generate-moe" if cfg.n_experts else "generate"
        groups = MOE_KERNEL_GROUPS if cfg.n_experts else KERNEL_GROUPS
        profile_steps(torch, lambda: prefill(model, ids_t, cfg, T + N_NEW, pad=pad), prefill_ms,
                      tag, groups, what="prefills")
        profile_steps(torch, decode, decode_ms, tag, groups, n=8, what="decode steps")
    return cfg, model, ids_t, lens_t, prefill_ms


def run_generate(torch, attn, cfg, model, ids_t, lens_t, prefill_ms, tag="generate"):
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
    log(f"[{tag}] flagship B{B} prompts {T} (real {prompt_lens().tolist()}) +{N_NEW} greedy: "
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


# generate-moe's first tokens, the plain run's routes pinned to the kernel
# run's: the two runs' prefill logits differ by bf16 rounding alone (on an
# H100: at most 0.047, and 0.066 in the dense cell), and a wrong kernel
# moves them by O(1).  A row whose plain top-2 gap is within twice the
# measured difference is a near-tie that either run may break its own way
# (the seed-0 MoE flagship has an exact tie, gap 0.0, and one of 0.03);
# every other row's first token must be equal.
MOE_FIRST_LOGIT_TOL = 0.125


def compare_with_plain_attention(torch, attn, cfg, model, ids_t, lens_t, out, tag="generate"):
    """The same generate with the attention forced to the plain version.
    For an MoE model the first tokens are held with the plain run's routes
    pinned to the kernel run's (MOE_FIRST_LOGIT_TOL), and compared
    unpinned beside them."""
    from cluster_anywhere_tpu_torch.models.generate import generate, prefill

    kernel = attn.flash_attention
    routes_k, routes_p = [], []
    plain = plain_attention(attn)
    with torch.no_grad():
        with moe_routes(routes_k):
            logits_k, _ = prefill(model, ids_t, cfg, T + 1, pad=T - lens_t)
        attn.flash_attention = plain
        try:
            ref = generate(model, ids_t, cfg=cfg, max_new_tokens=N_NEW, prompt_lens=lens_t)
            with moe_routes(routes_p):
                logits_p, _ = prefill(model, ids_t, cfg, T + 1, pad=T - lens_t)
            if cfg.n_experts:
                with moe_routes(routes_k, pin=True):
                    logits_pinned, _ = prefill(model, ids_t, cfg, T + 1, pad=T - lens_t)
        finally:
            attn.flash_attention = kernel
    top2 = logits_p.topk(2, dim=-1).values
    log(f"[{tag}] first-token logits, kernel vs plain attention: max |diff| "
        f"{(logits_k - logits_p).abs().max().item():.4g}; plain top-2 gap per row "
        f"{[round(g, 4) for g in (top2[:, 0] - top2[:, 1]).tolist()]}")
    first_ref, decided = ref[:, 0], torch.ones(B, dtype=torch.bool, device=out.device)
    if cfg.n_experts:
        unpinned = logits_p.argmax(dim=-1)
        diff = (logits_k - logits_pinned).abs().max().item()
        top2 = logits_pinned.topk(2, dim=-1).values
        decided = top2[:, 0] - top2[:, 1] > 2 * diff
        first_ref = logits_pinned.argmax(dim=-1).to(out.dtype)
        log(f"[{tag}] prefill routes agreeing, kernel vs plain attention: "
            f"{route_agreement(routes_k, routes_p):.6f} of {sum(r.numel() for r in routes_k)}; "
            f"first tokens equal unpinned: {(unpinned == out[:, 0]).sum().item()} of {B}; "
            f"the plain run's routes pinned to the kernel run's: max |diff| {diff:.4g} (limit "
            f"{MOE_FIRST_LOGIT_TOL}), top-2 gap per row "
            f"{[round(g, 4) for g in (top2[:, 0] - top2[:, 1]).tolist()]}, first tokens equal "
            f"{(first_ref == out[:, 0]).sum().item()} of {B}, near-ties {(~decided).sum().item()}")
        check(diff <= MOE_FIRST_LOGIT_TOL,
              f"prefill logits with the kernels differ from the plain attention by {diff}")
    check(torch.equal(out[decided, 0], first_ref[decided]),
          f"first tokens differ from the plain attention: {out[:, 0].tolist()} vs {first_ref.tolist()}")
    rate = (out[:, 1:] == ref[:, 1:]).float().mean().item()
    pinned = " (routes pinned)" if cfg.n_experts else ""
    log(f"[{tag}] vs plain attention: first tokens equal{pinned}, later tokens match rate "
        f"{rate:.4f} (bf16 may flip near-ties, after which a row's continuation diverges)")


SYSTEM_PROMPT = (
    "You are the operations assistant of a cluster that schedules tasks, actors "
    "and placement groups over many nodes. Answer in one short paragraph, name the "
    "component you rely on, and never invent metrics you were not given. When a "
    "node is draining, say which work moves and where. When an object is lost, "
    "explain lineage reconstruction. When a request is shed, cite the admission "
    "policy. Keep answers under fifty words. ")


def server_prompts():
    """The server cells' 8 prompts: one system prefix, 8 questions."""
    return [SYSTEM_PROMPT + f"Q{i}: why is node {i} slow?" for i in range(B)]


def flagship_spec(cfg):
    """A ModelSpec of cfg's widths for the ByteTokenizer, the weights from
    ModelSpec's seed (0)."""
    from cluster_anywhere_tpu_torch.llm import ModelSpec

    overrides = {f: getattr(cfg, f) for f in ("d_model", "n_layers", "n_heads", "n_kv_heads",
                                              "d_head", "d_ff", "max_seq_len", "dtype",
                                              "n_experts")}
    return ModelSpec(preset="custom", seed=0, config_overrides=overrides)


def server_config(cfg):
    """The server cells' ProcessorConfig: flagship_spec, the prefix cache on."""
    from cluster_anywhere_tpu_torch.llm import ProcessorConfig

    return ProcessorConfig(model=flagship_spec(cfg), max_prompt_len=T, max_new_tokens=N_NEW,
                           prefix_cache_entries=8)


def in_threads(fn, n):
    """[fn(i) for i < n], each call in its own thread, all started
    together; and the seconds until the last one returned."""
    out, errors = [None] * n, []

    def run(i):
        try:
            out[i] = fn(i)
        except Exception as e:  # reported below; fails the phase
            errors.append(repr(e))

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    check(not any(th.is_alive() for th in threads), "a request did not finish in 300 s")
    check(not errors, f"requests failed: {errors}")
    return out, time.perf_counter() - t0


def token_stream(items):
    """(seconds to the first item, the token ids) of a stream of
    {"token_id", "text"} items."""
    t0, first, toks = time.perf_counter(), None, []
    for item in items:
        first = time.perf_counter() - t0 if first is None else first
        toks.append(item["token_id"])
    return first, toks


def phase_server(torch, attn, cfg, tag="server"):
    """The server cell; returns each request's tokens and TTFT (s)."""
    from cluster_anywhere_tpu_torch.llm import ContinuousLLMServer

    pcfg = server_config(cfg)
    before = attn.flash_attention.launches
    srv = ContinuousLLMServer(pcfg, slots=8, device="cuda")
    try:
        prompts = server_prompts()
        streams, wall = in_threads(lambda i: token_stream(srv.stream({"prompt": prompts[i]})), B)
        ttft, tokens = [first for first, _ in streams], [toks for _, toks in streams]
        n_tok = [len(t) for t in tokens]
        check(all(n == N_NEW for n in n_tok), f"requests answered {n_tok} tokens, want {N_NEW}")
        check(srv.cb.cfg.n_experts == cfg.n_experts, f"the server runs {srv.cb.cfg}")
        stats = dict(srv.cb.stats)
        check(stats["prefix_hits"] >= 1, f"no prefix-cache hit: {stats}")
        srv.check_health()
        launches = attn.flash_attention.launches - before
        check(launches >= 1, "the server never launched flash_fwd")
        prompt_len = len(srv.tok.encode(prompts[0]))
        log(f"[{tag}] 8 concurrent requests, prompts {prompt_len} tokens sharing a "
            f"{len(SYSTEM_PROMPT)}-byte system prefix, {N_NEW} tokens each: TTFT p50 "
            f"{np.median(ttft) * 1e3:.1f} ms, max {max(ttft) * 1e3:.1f} ms; "
            f"{sum(n_tok) / wall:.1f} tok/s over {wall:.2f} s; stats {stats}; "
            f"flash_fwd launches {launches}")
        return {"tokens": tokens, "ttft": ttft, "tok_s": sum(n_tok) / wall}
    finally:
        srv.close()


# ----------------------------------------------------------------- phase 4b

NEAR_TIE_GAP = 0.125  # twice 0.066, the largest bf16 logit gap between two runs seen (flagship)


def counting_ingress():
    """The SSE ingress that build_continuous_llm_deployment deploys, plus
    one method that reads the replica's own process: its pid, the GPU it
    holds, the forward kernel's launch count (reset on request) and the
    library it loaded.  Defined in a function, so it travels by value to
    the replica's worker."""
    from cluster_anywhere_tpu_torch.llm.serve_llm import StreamingLLMIngress

    class CountingIngress(StreamingLLMIngress):
        def probe(self, reset=False):
            import os

            import torch

            from cluster_anywhere_tpu_torch.ops import _build
            from cluster_anywhere_tpu_torch.ops.attention import flash_attention

            out = {"pid": os.getpid(), "launches": flash_attention.launches,
                   "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
                   "params": str(self.cb.params.device),
                   "gpu": torch.cuda.get_device_name(self.cb.params.device),
                   "allocated_gb": torch.cuda.memory_allocated(self.cb.params.device) / 1e9,
                   "lib": str(_build.build("flash_fwd"))}
            if reset:
                flash_attention.launches = 0
            return out

    return CountingIngress


def http_post(url, body, timeout=300):
    """POST a JSON body; the JSON answer."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def sse_events(url, body, timeout=300):
    """POST a JSON body asking for text/event-stream; yields each event."""
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST", headers={
        "Content-Type": "application/json", "Accept": "text/event-stream"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        for raw in resp:
            line = raw.decode().strip()
            if line.startswith("data: "):
                yield json.loads(line[len("data: "):])


def top2_after(torch, pcfg, model_box, prompt, common):
    """The top two tokens and their logit gap after prompt (cut to
    pcfg.max_prompt_len tokens, as the inference worker cuts it) + common
    tokens (pcfg's weights, one plain prefill)."""
    from cluster_anywhere_tpu_torch.llm import ByteTokenizer
    from cluster_anywhere_tpu_torch.llm.processor import load_model
    from cluster_anywhere_tpu_torch.models.generate import prefill

    tcfg = pcfg.model.transformer_config(ByteTokenizer.vocab_size)
    if not model_box:
        model_box.append(load_model(pcfg, tcfg, torch.device("cuda")))
    prompt_ids = ByteTokenizer().encode(prompt)[: pcfg.max_prompt_len]
    ids = torch.tensor([prompt_ids + list(common)], device="cuda")
    with torch.no_grad():
        logits, _ = prefill(model_box[0], ids, tcfg, ids.shape[1] + 1)
    top = logits[0].float().topk(2)
    return top.indices.tolist(), (top.values[0] - top.values[1]).item()


def compare_rows(torch, pcfg, prompts, want, got, what, model_box, tag="serve-http"):
    """Each request's answer against the in-process run's tokens: token
    ids (SSE, a processor row) or text (a JSON answer).  A differing row
    must be a near-tie where it first differs: the in-process token and the
    other run's (for text, whichever token the other run took) are the top
    two, at most NEAR_TIE_GAP apart.  Returns the count of differing rows."""
    from cluster_anywhere_tpu_torch.llm import ByteTokenizer

    tok = ByteTokenizer()
    differing = 0
    for i, (w, g) in enumerate(zip(want, got)):
        if isinstance(g, str):
            if g == tok.decode(w):
                continue
            k = max(j for j in range(len(w) + 1) if g.startswith(tok.decode(w[:j])))
        else:
            if g == w:
                continue
            k = next(j for j in range(len(w)) if w[j] != g[j])
        differing += 1
        check(k < len(w), f"{what} row {i} has more than the in-process run's tokens")
        top, gap = top2_after(torch, pcfg, model_box, prompts[i], w[:k])
        tie = w[k] in top and gap <= NEAR_TIE_GAP and (isinstance(g, str) or g[k] in top)
        log(f"[{tag}] {what} row {i} differs from the in-process run at token {k} "
            f"(in-process {w[k]}, other {g if isinstance(g, str) else g[k]!r}): top two {top}, "
            f"logit gap {gap:.4f}, near-tie {tie}")
        check(tie, f"{what} row {i} differs from the in-process run, and not on a near-tie")
    return differing


def phase_serve_http(torch, attn, cfg, server):
    """The server cell's requests over HTTP: the port's runtime and Serve,
    build_continuous_llm_deployment with one GPU replica in its own
    process, the proxy on a port the OS picks.  Returns the replica's
    forward launches, read inside the replica."""
    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch import serve
    from cluster_anywhere_tpu_torch.core import api
    from cluster_anywhere_tpu_torch.llm import build_continuous_llm_deployment
    from cluster_anywhere_tpu_torch.ops import _build
    from cluster_anywhere_tpu_torch.util import state

    torch.cuda.empty_cache()
    lib = _build.build("flash_fwd")
    lib_mtime = lib.stat().st_mtime_ns
    check("CA_NUM_GPUS" not in os.environ, "CA_NUM_GPUS is set: the cell checks detection")
    t0 = time.perf_counter()
    info = ca.init(num_cpus=4)
    try:
        log(f"[serve-http] ca.init: resources {info['resources']}, session {info['session_dir']}")
        check(info["resources"].get("GPU") == 1.0,
              f"the runtime detected {info['resources'].get('GPU')} GPUs, want 1")
        serve.start(port=0)
        url = ca.get(ca.get_actor(serve.PROXY_NAME).ready.remote(), timeout=60) + "/llm"
        app = build_continuous_llm_deployment(server_config(cfg), num_gpus=1, slots=8,
                                              sse_ingress=True)
        app.deployment.func_or_class = counting_ingress()  # same options, the probe added
        handle = serve.run(app, name="llm", route_prefix="/llm", wait_timeout_s=240)
        startup = time.perf_counter() - t0
        probe = handle.options(method_name="probe").remote(reset=True).result(timeout_s=60)
        log(f"[serve-http] replica ready {startup:.2f} s after ca.init: pid {probe['pid']} "
            f"(driver {os.getpid()}), {probe['gpu']}, params on {probe['params']}, "
            f"{probe['allocated_gb']:.2f} GB allocated, CUDA_VISIBLE_DEVICES "
            f"{probe['visible']!r}, kernel library {probe['lib']}")
        check(probe["pid"] != os.getpid(), "the replica runs in the driver's process")
        check(probe["params"].startswith("cuda") and probe["allocated_gb"] > 0.1,
              f"the replica does not hold the GPU: {probe}")
        check(probe["lib"] == str(lib) and lib.stat().st_mtime_ns == lib_mtime,
              f"the replica did not load the driver's build of flash_fwd: {probe['lib']}")

        prompts, want = server_prompts(), server["tokens"]
        zero_launch_counts(attn)
        # SSE first: a fresh replica's first wave, as the in-process cell's
        # fresh server (one prefix miss, seven hits), so their TTFTs compare
        def sse(i):
            return token_stream(sse_events(url, {"prompt": prompts[i]}))

        streams, sse_wall = in_threads(sse, B)
        answers, wall = in_threads(lambda i: http_post(url, {"prompt": prompts[i]}), B)
        # and SSE again on the warm replica: what the first wave's start costs
        warm, warm_wall = in_threads(sse, B)
        after = handle.options(method_name="probe").remote().result(timeout_s=60)
        driver_launches = launch_counts(attn)
        check(all(a["num_generated_tokens"] == N_NEW for a in answers),
              f"HTTP answers have {[a['num_generated_tokens'] for a in answers]} tokens")
        check(all(len(toks) == N_NEW for _, toks in streams + warm),
              f"SSE streams have {[len(t) for _, t in streams + warm]} events, want {N_NEW}")
        model_box = []  # the server cell's weights, loaded once if a row differs
        pcfg = server_config(cfg)
        differing = compare_rows(torch, pcfg, prompts, want,
                                 [a["generated_text"] for a in answers], "HTTP", model_box)
        sse_differing = compare_rows(torch, pcfg, prompts, want, [t for _, t in streams], "SSE",
                                     model_box)
        warm_differing = compare_rows(torch, pcfg, prompts, want, [t for _, t in warm],
                                      "SSE (warm)", model_box)
        del model_box
        check(after["pid"] == probe["pid"], "the replica changed during the cell")
        check(driver_launches == (0, 0, 0),
              f"the driver launched kernels during the HTTP cell: {driver_launches}")
        check(after["launches"] >= cfg.n_layers,
              f"the replica launched flash_fwd {after['launches']} times, want >= {cfg.n_layers}")
        ttft = [first for first, _ in streams]
        warm_ttft = [first for first, _ in warm]
        log(f"[serve-http] 8 concurrent SSE streams (the replica's first wave), {N_NEW} tokens "
            f"each: TTFT p50 {np.median(ttft) * 1e3:.1f} ms, max {max(ttft) * 1e3:.1f} ms, "
            f"{B * N_NEW / sse_wall:.1f} tok/s over {sse_wall:.2f} s, {B - sse_differing} of {B} "
            f"streams equal to the in-process server's; then 8 concurrent JSON POSTs (prefix "
            f"cached): {B * N_NEW / wall:.1f} tok/s over {wall:.2f} s, {B - differing} of {B} "
            f"texts equal; SSE again: TTFT p50 {np.median(warm_ttft) * 1e3:.1f} ms, max "
            f"{max(warm_ttft) * 1e3:.1f} ms, {B * N_NEW / warm_wall:.1f} tok/s, "
            f"{B - warm_differing} of {B} equal; in-process server (same call): TTFT p50 "
            f"{np.median(server['ttft']) * 1e3:.1f} ms, max {max(server['ttft']) * 1e3:.1f} ms, "
            f"{server['tok_s']:.1f} tok/s; replica start-up {startup:.2f} s; replica flash_fwd "
            f"launches {after['launches']}")
        pids = [w["pid"] for w in state.list_workers()] + [api._head_proc.pid]
    finally:
        serve.shutdown()
        ca.shutdown()
    deadline = time.monotonic() + 30
    alive = pids
    while alive and time.monotonic() < deadline:
        alive = [p for p in alive if _pid_alive(p)]
        time.sleep(0.2)
    check(not alive, f"processes of the port's session still alive after shutdown: {alive}")
    log(f"[serve-http] serve.shutdown() and ca.shutdown(): none of {len(pids)} processes "
        f"(head and workers) left")
    return after["launches"]


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:  # a zombie child of this process is gone but not yet reaped
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


# ----------------------------------------------------------------- phase 4c

PROC_ROWS = 60  # the processor cell's rows, batches of B


@contextlib.contextmanager
def watchdog(seconds, what):
    """Ends the whole script if the block has not finished in `seconds`: a
    GPU actor the cluster cannot place would otherwise wait forever."""
    def fire():
        log(f"[watchdog] {what} did not finish in {seconds} s; exiting")
        os._exit(3)

    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()


def processor_rows():
    """The processor cell's input: 60 rows, each an id and a prompt of
    64-440 bytes of lowercase words, from numpy's seed 0."""
    rng = np.random.default_rng(0)
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz    ", dtype=np.uint8)
    return [{"id": i, "text": rng.choice(letters, int(n)).tobytes().decode()}
            for i, n in enumerate(rng.integers(64, 441, PROC_ROWS))]


def processor_config(cfg):
    """The processor cell's ProcessorConfig: the server cell's weights and
    system prefix, the chat template on, batches of 8, one actor."""
    from cluster_anywhere_tpu_torch.llm import ProcessorConfig

    return ProcessorConfig(model=flagship_spec(cfg), batch_size=B, concurrency=1,
                           max_prompt_len=T, max_new_tokens=N_NEW, temperature=0.0,
                           apply_chat_template=True, system_prompt=SYSTEM_PROMPT)


def counting_worker():
    """_InferenceWorker as the Processor runs it, plus columns that read the
    actor's own process for each batch: its pid, the batch's index, the
    forward kernel's launches during the batch, the GPU it holds and the
    library it loaded, and the wall-clock times of its start and of the
    batch's start and end.  Defined in a function, so it travels by value to the
    actor's worker."""
    from cluster_anywhere_tpu_torch.llm.processor import _InferenceWorker

    class CountingWorker(_InferenceWorker):
        def __init__(self, *args, **kwargs):
            import time

            super().__init__(*args, **kwargs)
            self.batches, self.ready_at = 0, time.time()

        def __call__(self, batch, **kwargs):
            import os
            import time

            import numpy as np
            import torch

            from cluster_anywhere_tpu_torch.ops import _build
            from cluster_anywhere_tpu_torch.ops.attention import flash_attention

            before, started_at = flash_attention.launches, time.time()
            out = super().__call__(batch, **kwargs)
            self.batches += 1
            dev = self.device
            probe = {"pid": os.getpid(), "batch": self.batches,
                     "launches": flash_attention.launches - before,
                     "visible": str(os.environ.get("CUDA_VISIBLE_DEVICES")),
                     "params": str(self.params.device),
                     "gpu": torch.cuda.get_device_name(dev),
                     "allocated_gb": torch.cuda.memory_allocated(dev) / 1e9,
                     "lib": str(_build.build("flash_fwd")), "ready_at": self.ready_at,
                     "started_at": started_at, "done_at": time.time()}
            n = len(out["generated_tokens"])
            out["actor"] = np.asarray([probe] * n, dtype=object)
            return out

    return CountingWorker


def phase_processor(torch, attn, cfg):
    """The processor cell: build_llm_processor over cad.from_items, the
    inference in one GPU actor the Data executor starts (the Processor's own
    map_batches call, its worker class counting inside the actor).  Returns
    the actor's forward launches."""
    import cluster_anywhere_tpu_torch.data as cad
    from cluster_anywhere_tpu_torch import llm
    from cluster_anywhere_tpu_torch.llm import processor as proc_mod
    from cluster_anywhere_tpu_torch.ops import _build

    def preprocess(row):  # nested, like the stages below: they travel by value
        return {"id": row["id"], "prompt": row["text"]}

    def postprocess(row):
        return {"id": row["id"], "prompt": row["prompt"], "tokens": row["generated_tokens"],
                "actor": row["actor"]}

    pcfg = processor_config(cfg)
    lib = _build.build("flash_fwd")
    lib_mtime = lib.stat().st_mtime_ns
    processor = llm.build_llm_processor(pcfg, preprocess=preprocess, postprocess=postprocess)
    real = proc_mod._InferenceWorker
    proc_mod._InferenceWorker = counting_worker()
    try:
        ds = processor(cad.from_items(processor_rows()))
    finally:
        proc_mod._InferenceWorker = real
    zero_launch_counts(attn)
    start_wall, t0 = time.time(), time.perf_counter()
    with watchdog(600, "the processor cell's pipeline"):
        rows = ds.take_all()
    wall = time.perf_counter() - t0
    driver_launches = launch_counts(attn)

    ids = sorted(r["id"] for r in rows)
    check(ids == list(range(PROC_ROWS)), f"the pipeline returned ids {ids}")
    batches = {r["actor"]["batch"]: r["actor"] for r in rows}
    actor = batches[max(batches)]
    startup = actor["ready_at"] - start_wall
    log(f"[processor] actor: pid {actor['pid']} (driver {os.getpid()}), {actor['gpu']}, params on "
        f"{actor['params']}, {actor['allocated_gb']:.2f} GB allocated, CUDA_VISIBLE_DEVICES "
        f"{actor['visible']!r}, kernel library {actor['lib']}; ready {startup:.2f} s after "
        f"take_all began")
    check({p["pid"] for p in batches.values()} == {actor["pid"]} and actor["pid"] != os.getpid(),
          f"the pipeline did not run in one actor of its own: {batches}")
    check(actor["params"].startswith("cuda") and actor["allocated_gb"] > 0.1,
          f"the actor does not hold the GPU: {actor}")
    check(actor["lib"] == str(lib) and lib.stat().st_mtime_ns == lib_mtime,
          f"the actor did not load the driver's build of flash_fwd: {actor['lib']}")
    per_batch = [batches[b]["launches"] for b in sorted(batches)]
    check(all(n >= cfg.n_layers for n in per_batch),
          f"the actor's batches launched flash_fwd {per_batch} times, want >= {cfg.n_layers} each")
    check(driver_launches == (0, 0, 0),
          f"the driver launched kernels during the pipeline: {driver_launches}")

    # the same templated prompts through the in-process worker, 8 at a time
    by_id = {r["id"]: r for r in rows}
    prompts = [by_id[i]["prompt"] for i in range(PROC_ROWS)]
    worker = real(pcfg, "cuda")
    want, local = [], []
    for lo in range(0, PROC_ROWS, B):
        t1 = time.perf_counter()
        out = worker({"prompt": np.asarray(prompts[lo:lo + B], dtype=object)})
        local.append(time.perf_counter() - t1)
        want.extend(row.tolist() for row in out["generated_tokens"])
    local_s = sum(local)
    del worker
    torch.cuda.empty_cache()
    got = [by_id[i]["tokens"].tolist() for i in range(PROC_ROWS)]
    check(all(len(g) == N_NEW for g in got), "a row has not 32 generated tokens")
    check(all(p.startswith(f"<|system|>{SYSTEM_PROMPT}<|user|>") and p.endswith("<|assistant|>")
              for p in prompts), "a row's prompt is not the chat template's")
    model_box = []
    differing = compare_rows(torch, pcfg, prompts, want, got, "row", model_box, tag="processor")
    del model_box
    steady = max(p["done_at"] for p in batches.values()) - actor["ready_at"]
    order = [batches[b] for b in sorted(batches)]
    busy = [p["done_at"] - p["started_at"] for p in order]
    idle = [p["started_at"] - q["done_at"] for q, p in zip([{"done_at": actor["ready_at"]}] + order,
                                                          order)]
    tokens = PROC_ROWS * N_NEW
    log(f"[processor] {PROC_ROWS} rows ({len(batches)} batches, prompts cut to {T} tokens of "
        f"{min(len(p) for p in prompts) + 1}-{max(len(p) for p in prompts) + 1}), {N_NEW} greedy "
        f"tokens each: pipeline {wall:.2f} s, {PROC_ROWS / wall:.2f} rows/s, "
        f"{tokens / wall:.1f} generated tok/s; after the actor's start-up ({startup:.2f} s) "
        f"{tokens / steady:.1f} tok/s over {steady:.2f} s; in-process worker over the same "
        f"prompts (same call) {tokens / local_s:.1f} tok/s over {local_s:.2f} s; "
        f"{PROC_ROWS - differing} of {PROC_ROWS} rows equal to the in-process worker's; actor "
        f"flash_fwd launches per batch {per_batch}, driver launches {driver_launches}")
    log(f"[processor] the actor's seconds in each call, in batch order: "
        f"{' '.join(f'{b:.3f}' for b in busy)}; waiting before each call: "
        f"{' '.join(f'{w:.3f}' for w in idle)}; the in-process worker's seconds a batch "
        f"{' '.join(f'{t:.3f}' for t in local)}")
    return sum(per_batch)


def phase_train_data(torch, attn, cfg, train_ms):
    """The train-data cell: the train cell's step fed by
    cad.from_numpy(ids).iter_torch_batches (the card, prefetch 1).  Returns
    the cell's launches (fwd, dQ, dK/dV)."""
    import cluster_anywhere_tpu_torch.data as cad
    from cluster_anywhere_tpu_torch.models import make_train_step

    n = TRAIN_STEPS + 1
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (TRAIN_B * n, TRAIN_T + 1))
    step, init_state = make_train_step(cfg)
    model, opt = init_state(0)
    _, _, host_loss = step(model, opt, {"ids": torch.from_numpy(ids[:TRAIN_B]).cuda()})
    host_loss = host_loss.item()
    model, opt = init_state(0)
    zero_launch_counts(attn)
    it = iter(cad.from_numpy(ids).iter_torch_batches(batch_size=TRAIN_B, prefetch=1))
    batches, losses, waits = [], [], []
    with watchdog(600, "the train-data cell"):
        for i in range(n):
            t0 = time.perf_counter()
            batch = next(it)
            waits.append((time.perf_counter() - t0) * 1e3)
            if i == 1:  # the warm-up step is done: time the rest
                torch.cuda.synchronize()
                t_start = time.perf_counter()
            batches.append(batch["data"])
            losses.append(step(model, opt, {"ids": batch["data"]})[2])
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t_start) / TRAIN_STEPS * 1e3
        extra = next(it, None)
    launches = launch_counts(attn)
    # the same step on one batch already on the card, in this session: what
    # the session costs a step, apart from the iteration
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        step(model, opt, {"ids": batches[-1]})
    torch.cuda.synchronize()
    fixed_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    check(extra is None, "iter_torch_batches gave more than the dataset's batches")
    for i, got in enumerate(batches):
        check(got.is_cuda and got.dtype == torch.int64,
              f"batch {i} is {got.dtype} on {got.device}, want int64 on the card")
        check(torch.equal(got.cpu(), torch.from_numpy(ids[i * TRAIN_B:(i + 1) * TRAIN_B])),
              f"batch {i} differs from its rows of ids")
    losses = [x.item() for x in losses]
    rel = abs(losses[0] - host_loss) / abs(host_loss)
    log(f"[train-data] cad.from_numpy(ids {ids.shape} {ids.dtype}).iter_torch_batches(batch_size="
        f"{TRAIN_B}, prefetch=1): {n} batches, each int64 on the card and equal to its rows of ids; "
        f"step {step_ms:.2f} ms over {TRAIN_STEPS} steps (host clock, ending in synchronize) against "
        f"the train cell's {train_ms:.2f} ms in this call ({step_ms / train_ms:.3f}x) and the "
        f"same step on one batch already on the card in this session {fixed_ms:.2f} ms; host wait "
        f"for each batch (ms) {' '.join(f'{w:.3f}' for w in waits)}; step 1's loss {losses[0]:.6f} "
        f"vs {host_loss:.6f} from the host's rows (relative {rel:.3g}, limit 1e-6); loss over "
        f"{n} steps {' '.join(f'{x:.4f}' for x in losses)}; launches (fwd, dQ, dK/dV) {launches}")
    check(rel <= 1e-6, f"step 1's loss {losses[0]} differs from the host's rows' {host_loss}")
    check(all(np.isfinite(losses)), f"non-finite train-data loss: {losses}")
    check(launches == (cfg.n_layers * n,) * 3,
          f"the train-data cell launched (fwd, dQ, dK/dV) {launches}, want {cfg.n_layers * n} each")
    return launches


def phase_data(torch, attn, cfg, train_ms):
    """The processor and train-data cells on one session of the port's
    runtime (ca.init detects the GPU); no process of it left after
    shutdown.  Returns their launches (fwd, dQ, dK/dV), the actor's
    included."""
    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch.core import api
    from cluster_anywhere_tpu_torch.util import state

    torch.cuda.empty_cache()
    info = ca.init(num_cpus=4)
    try:
        check(info["resources"].get("GPU") == 1.0,
              f"the runtime detected {info['resources'].get('GPU')} GPUs, want 1")
        actor_fwd = phase_processor(torch, attn, cfg)
        train = phase_train_data(torch, attn, cfg, train_ms)
        pids = [w["pid"] for w in state.list_workers()] + [api._head_proc.pid]
    finally:
        ca.shutdown()
    deadline = time.monotonic() + 30
    alive = pids
    while alive and time.monotonic() < deadline:
        alive = [p for p in alive if _pid_alive(p)]
        time.sleep(0.2)
    check(not alive, f"processes of the port's session still alive after shutdown: {alive}")
    return (train[0] + actor_fwd,) + train[1:]


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


def zero_launch_counts(attn):
    attn.flash_attention.launches = attn.flash_bwd_dq.launches = attn.flash_bwd_dkv.launches = 0


def check_serving_launches(tag, counts):
    check(counts[0] > 0 and counts[1:] == (0, 0),
          f"{tag} launched (fwd, dQ, dK/dV) {counts}: want the forward only")


def phase_train(torch, attn):
    """entry()'s forward step, then the flagship's training cell."""
    from cluster_anywhere_tpu_torch.entry import entry

    fn, args = entry()  # the forward step at ids (4, 1024), as __graft_entry__.entry
    logits = fn(*args)
    check(tuple(logits.shape) == (4, 1024, 32000) and bool(torch.isfinite(logits).all()),
          f"entry() forward gave {tuple(logits.shape)} {logits.dtype}, or non-finite logits")
    log(f"[entry] forward step on ids (4, 1024): logits {tuple(logits.shape)} {logits.dtype}, finite")
    del fn, args, logits
    return train_cell(torch, attn, flagship())


def train_cell(torch, attn, cfg, tag="train"):
    """make_train_step on a fixed batch: 1 warm-up step, then TRAIN_STEPS
    timed steps and 3 profiled; every step launches each kernel once per
    layer.  MFU only for the dense model (bench.py:387-390).  Returns the
    timed steps' ms a step."""
    from cluster_anywhere_tpu_torch.models import make_train_step

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
    tok_s = TRAIN_B * TRAIN_T / step_s
    mfu = ""
    if not cfg.n_experts:
        flops = model_flops_per_step(cfg, TRAIN_B, TRAIN_T, causal_discount=True)
        mfu = (f"MFU {flops / step_s / BF16_FLOPS * 100:.2f}% of 989 TFLOP/s "
               f"({flops / 1e12:.2f} TFLOP/step, causal-discounted), ")
    log(f"[{tag}] flagship{f' {cfg.n_experts} experts top-1' if cfg.n_experts else ''} "
        f"B{TRAIN_B} T{TRAIN_T}, AdamW lr 3e-4: step {step_s * 1e3:.2f} ms "
        f"(host clock over {TRAIN_STEPS} steps ending in synchronize), {tok_s:.0f} tok/s, {mfu}"
        f"peak memory {peak_gb:.2f} GB; loss over {len(losses)} steps "
        f"{' '.join(f'{x:.4f}' for x in losses)}; launches per step (fwd, dQ, dK/dV) "
        f"{sorted(set(per_step))}")
    check(all(np.isfinite(losses)), f"non-finite training loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall from step 1 to step {len(losses)}: {losses}")
    check(all(c == want for c in per_step),
          f"a training step launched (fwd, dQ, dK/dV) {per_step}, want {want} each")
    # the serving copy (cast here, after the peak memory is read) follows
    # the profiled steps of the card's (multi-tensor) AdamW
    served = model.compute_weights()["blocks"][0]["wq"].clone()
    profile_steps(torch, lambda: step(model, opt, batch), step_s * 1e3, tag,
                  MOE_KERNEL_GROUPS if cfg.n_experts else KERNEL_GROUPS)
    now = model.compute_weights()["blocks"][0]["wq"]
    fresh = torch.equal(now, model.blocks[0].wq.detach().to(cfg.dtype))
    log(f"[{tag}] serving weights after the profiled steps are the trained ones: {fresh}")
    check(fresh and not torch.equal(now, served),
          "compute_weights serves weights from before the optimizer steps")
    return step_s * 1e3


KERNEL_GROUPS = (  # (group, substrings of the kernel names it takes), first match wins
    ("flash attention (this repo)", ("flash_fwd", "bwd_dq", "bwd_dkv")),
    ("matmul (cuBLAS)", ("gemm", "xmma", "nvjet", "cutlass", "sm90_")),
    ("AdamW (multi_tensor_apply)", ("multi_tensor", "adam")),
    ("other (elementwise, reductions, copies)", ("",)),
)
# the MoE step's router softmax, top-1 argmax, queue cumsum, slot copy and
# gathers, and their backward (the one-hot's comparison and the gate's
# products are elementwise, in "other"); the expert products are cuBLAS
# matmuls.  The cross-entropy's gather of the gold logits falls here too.
MOE_KERNEL_GROUPS = KERNEL_GROUPS[:3] + (
    ("MoE routing and dispatch", ("softmax", "argmax", "scan", "cumsum", "index_copy",
                                  "indexselect", "indexfunc", "scatter", "gather")),
) + KERNEL_GROUPS[3:]


def profile_steps(torch, fn, step_ms, tag, kernel_groups, n=3, what="training steps"):
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
    groups = {g: 0.0 for g, _ in kernel_groups}
    for e in kernels:
        name = e.key.lower()
        group = next(g for g, keys in kernel_groups if any(k in name for k in keys))
        groups[group] += e.self_device_time_total / 1e3 / n
    log(f"[profile] {tag}, {n} {what}: device busy {busy_ms:.2f} ms a step; idle share of the "
        f"unprofiled step ({step_ms:.2f} ms) {max(0.0, 1 - busy_ms / step_ms) * 100:.1f}%; gaps on "
        f"the device timeline of the profiled steps {(1 - covered / window) * 100:.1f}% of "
        f"{window / 1e3 / n:.2f} ms a step; device ms a step by group: "
        + "; ".join(f"{g} {ms:.2f}" for g, ms in groups.items()))
    ours = [e for e in kernels if any(k in e.key.lower() for k in kernel_groups[0][1])]
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12] + ours:
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


def compare_train_with_plain_attention(torch, attn, cfg, tag="train"):
    """The same loss and gradients on a fresh model of `cfg` with the
    attention forced to the plain version (autograd through
    _flash_attention_plain).  For an MoE model the plain run's routes are
    pinned to the kernel run's for the check, and a plain run routing on
    its own is compared beside it (the share of routes that agree)."""
    from cluster_anywhere_tpu_torch.models import init_params, make_loss_fn

    model = init_params(cfg, 1, device="cuda")
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    loss_fn = make_loss_fn(cfg)
    batch = train_batch(torch, cfg)
    kernel = attn.flash_attention
    routes_k, routes_p = [], []

    def loss_and_grads(routes, pin=False):
        with moe_routes(routes, pin):
            loss = loss_fn(model, batch)
            return loss, torch.autograd.grad(loss, params)

    def compare(what, loss_k, grads_k, loss_p, grads_p):
        loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        worst_rel, worst_cos = (0.0, ""), (1.0, "")
        for name, gk, gp in zip(names, grads_k, grads_p):
            gk, gp = gk.double(), gp.double()
            rel = ((gk - gp).norm() / gp.norm()).item()
            cos = (gk.flatten() @ gp.flatten() / (gk.norm() * gp.norm())).item()
            worst_rel = max(worst_rel, (rel, name))
            worst_cos = min(worst_cos, (cos, name))
        log(f"[{tag}] one step, kernels vs plain attention{what}: loss {loss_k.item():.6f} vs "
            f"{loss_p.item():.6f} (relative {loss_rel:.3g}); worst per-parameter gradient relative "
            f"L2 error {worst_rel[0]:.4g} ({worst_rel[1]}), lowest cosine {worst_cos[0]:.6f} "
            f"({worst_cos[1]}); tolerances {TRAIN_GRAD_TOL}")
        return loss_rel <= TRAIN_GRAD_TOL["loss_rel"] and worst_rel[0] <= TRAIN_GRAD_TOL["grad_rel_l2"]

    loss_k, grads_k = loss_and_grads(routes_k)
    attn.flash_attention = plain_attention(attn)
    try:
        loss_p, grads_p = loss_and_grads(routes_p)
        if cfg.n_experts:
            pinned = loss_and_grads(routes_k, pin=True)
    finally:
        attn.flash_attention = kernel
    ok = compare("", loss_k, grads_k, loss_p, grads_p)
    if cfg.n_experts:
        log(f"[{tag}] routes agreeing, kernel vs plain attention: "
            f"{route_agreement(routes_k, routes_p):.6f} of {sum(r.numel() for r in routes_k)} "
            f"(the comparison above; held below, routes pinned)")
        ok = compare(", the plain run's routes pinned to the kernel run's", loss_k, grads_k,
                     *pinned)
    check(ok, "training gradients with the kernels disagree with the plain attention")


def module_origin(name):
    """Whether a module imports here, its version and where from."""
    import importlib

    try:
        mod = importlib.import_module(name)
    except ImportError as e:
        return f"{name} does not import ({e})"
    return f"{name} {getattr(mod, '__version__', '?')} from {os.path.dirname(mod.__file__)}"


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
    import cloudpickle
    import msgpack

    codec = "C extension" if msgpack.Packer.__module__ == "msgpack._cmsgpack" else "pure Python"
    log(f"[env] runtime codecs: msgpack {'.'.join(map(str, msgpack.version))} ({codec}) from "
        f"{os.path.dirname(msgpack.__file__)}, cloudpickle {cloudpickle.__version__} from "
        f"{os.path.dirname(cloudpickle.__file__)}")
    log(f"[env] the Data library's Arrow and pandas edges: {module_origin('pyarrow')}; "
        f"{module_origin('pandas')}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    phase_build()
    fwd_err = phase_kernel_check(torch, attn, gen)
    dq_err, dkv_err = phase_bwd_check(torch, attn, gen)
    log(f"[clocks] clocks.sm, clocks.max.sm before the timing phases: {gpu_clocks()}")
    fwd_timing = phase_kernel_timing(torch, attn, gen)
    dq_timing, dkv_timing = phase_bwd_timing(torch, attn, gen)
    log(f"[clocks] clocks.sm, clocks.max.sm after the timing phases: {gpu_clocks()}")
    cfg, model, ids_t, lens_t, prefill_ms = phase_generate(torch, flagship())

    # the main path starts here
    zero_launch_counts(attn)
    out = run_generate(torch, attn, cfg, model, ids_t, lens_t, prefill_ms)
    server = phase_server(torch, attn, cfg)
    serving = launch_counts(attn)
    train_ms = phase_train(torch, attn)
    launches = launch_counts(attn)  # ... and ends here
    log(f"[main path] launches (fwd, dQ, dK/dV): serving {serving}, in all {launches}")
    check_serving_launches("serving", serving)
    check(all(n > 0 for n in launches), f"a kernel was not launched on the main path: {launches}")

    # the server cell over HTTP: zeroed and read in the driver and, for the
    # launches that count, inside the replica's process
    replica_fwd = phase_serve_http(torch, attn, cfg, server)
    launches = (launches[0] + replica_fwd,) + launches[1:]
    # the processor and train-data cells: the actor's launches read inside
    # it, the train-data launches between zeroed counts
    data = phase_data(torch, attn, cfg, train_ms)
    log(f"[data paths] launches (fwd, dQ, dK/dV), the processor actor's included: {data}")
    launches = tuple(map(sum, zip(launches, data)))

    # the MoE cells, each read between zeroed counts
    moe = moe_flagship()
    mcfg, mmodel, _, _, mprefill_ms = phase_generate(torch, moe)
    zero_launch_counts(attn)
    mout = run_generate(torch, attn, mcfg, mmodel, ids_t, lens_t, mprefill_ms, "generate-moe")
    counts = {"generate-moe": launch_counts(attn)}
    zero_launch_counts(attn)
    phase_server(torch, attn, moe, "server-moe")
    counts["server-moe"] = launch_counts(attn)
    zero_launch_counts(attn)
    train_cell(torch, attn, moe, "train-moe")
    counts["train-moe"] = launch_counts(attn)
    log(f"[moe paths] launches (fwd, dQ, dK/dV): {counts}")
    for tag in ("generate-moe", "server-moe"):
        check_serving_launches(tag, counts[tag])
    check(all(n > 0 for n in counts["train-moe"]),
          f"a kernel was not launched on the train-moe path: {counts['train-moe']}")
    launches = tuple(map(sum, zip(launches, *counts.values())))

    compare_with_plain_attention(torch, attn, cfg, model, ids_t, lens_t, out)
    compare_with_plain_attention(torch, attn, mcfg, mmodel, ids_t, lens_t, mout, "generate-moe")
    del model, mmodel
    compare_train_with_plain_attention(torch, attn, flagship())
    compare_train_with_plain_attention(torch, attn, moe, "train-moe")
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
