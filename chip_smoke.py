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
     an LSE cotangent, the flagship prefill and training shapes, and the
     blocks phase 7's ring and Ulysses attention give the kernels; O and
     the gradients also row by row), and two calls of each kernel on the
     same inputs to the same bits;
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
     to the in-process server's or differing only on a near-tie, every
     SSE stream on the compiled shm stream (dag_stream handshakes counted
     in the replica, none of the proxy's streams on RPC or fallen back),
     the forward's launches read inside the replica, and no process of the
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
  7. the parallel stack (parallel/, the sharded make_train_step): 4 ranks
     spawned once, sharing the one card over gloo, run a probe (each
     collective of the tensor plane on CUDA tensors, which of them stage
     through host memory, quantized_psum's int8 error on a wq-sized
     gradient) and then six cells at flagship width, each on a fresh
     mesh: pp2 x tp2, ring sp2 x tp2, Ulysses sp4, MoE dp2 x ep2, MoE
     pp2 x ep2 and fsdp2 x tp2 (MoE at capacity 4.0, no token dropped).
     Each is held to the one-device step on the same weights and batch,
     run in this process before the ranks start (step 1's loss to 1e-3,
     every gathered gradient to 5e-2 relative L2; the MoE ranks' routes
     pinned to the reference's, and the share of their own routes that
     agree with it printed), its loss must fall over 4 steps, and
     each kernel must launch inside the ranks; step ms, peak memory per
     rank and the bytes each collective moved are printed (4 ranks on one
     card: not a scaling number).  A rank that fails or hangs fails the
     phase, and the others are killed.
  8. the Train library, on a session of the port's runtime of its own, at
     the flagship's widths and 4 of its 8 layers (TL_LAYERS): train-lib,
     TorchTrainer(...).fit() with one GPU worker training it from seed 0
     on the train-data cell's rows (cad.from_numpy,
     get_dataset_shard(...).iter_torch_batches) for 12 steps, saving
     params and AdamW state (Checkpoint.save_pytree, keep 2) after steps 6
     and 12 (step 1's loss to 1e-6 of the one-device step's on the same
     batch, run here first, the loss falling, 4 launches of each kernel a
     step counted inside the worker, none in the driver); the same fit
     failing once after step 9, which the
     controller restarts from step 6's checkpoint (steps 7-12 to 1e-6 of
     the first fit's, Result.checkpoint's params bit-equal to the
     worker's); train-lib-fsdp, 4 workers at 0.25 GPU on one fsdp2 x tp2
     mesh over TorchConfig's gloo group, 5 steps with save_pytree_sharded
     after step 4, then 2 workers on fsdp2 resuming from it (step 5's loss
     to 1e-3 of the 4-worker run's); and the host collective groups' probe
     (4 actors, every op on a CUDA tensor of 1024 x 1024, f32 equal to the
     driver's to the bit, int8 within its bound).  Under one watchdog.
  9. the device plane: entry.dryrun_device_plane() (a DTensor and a bf16
     tensor between two GPU actors over a compiled DAG, strict), then on a
     session of the port's runtime of its own, two actors at 0.5 GPU with
     the flagship from seed 0: device-ref, the Prefiller's prefill of the
     generate cell's prompts returned as CUDA tensors (the cache 8 layers
     x [8, 544, 4, 128] bf16 for k and v), the ref passed back to it
     resolving to the stored object (same data_ptr), passed to the Decoder,
     whose 32 greedy tokens a row equal the generate cell's (or differ on
     a near-tie), and got by the driver with the actor's bytes (sha256);
     the hop's ms and GB/s (the Decoder's call, the driver's get, median
     of 5 fresh refs) and the Prefiller's memory_allocated before the hop
     and after the driver dropped every ref; dag-transport,
     decode.bind(prefill.bind(inp).with_tensor_transport()) compiled and
     run on 3 prompt sets under CA_DEVICE_TRANSPORT_STRICT (every leaf
     landed on cuda, none on the CPU; tokens held to generate's), the
     execute's ms (median of 5 after a warm-up); then one SSE wave of the
     serve-http cell with serve_compiled_dag=False (the streaming-RPC
     transport), its TTFT and token inter-arrival printed beside phase
     4b's on the compiled stream.  Under one watchdog.  After every ref
     is dropped the Prefiller holds no device object and at most 80 MB
     above its level after the first prefill (the owner releases what an
     actor holds).
  10. the RL library (cluster_anywhere_tpu_torch.rl), which runs no flash
     kernel (its launches are zeroed before and must read 0 after):
     rl-learners, every learner (PPO, recurrent PPO, DQN with PER, IMPALA,
     APPO, SAC, TD3, BC, CQL, MARWIL, DreamerV3's world-model and
     actor-critic steps) 3 updates on the card held to the same 3 on the
     CPU from the same params, batches and noise (losses 1e-5 relative,
     params 1e-4 relative L2), each update's ms on both; then on a session of the port's
     runtime of its own, rl-ppo, tests/test_rl.py's PPO on CartPole (2
     runners x 4 envs, rollout 128, 6 epochs, 12 iterations) with the
     learner on the card and the runners as CPU actors, which must learn
     (the final evaluation above max(2 x the first, 80)), its iteration,
     update and sampling ms, env steps/s and the device's busy share of a
     profiled iteration; rl-ppo-dag, the same over the compiled DAG, whose
     first rollouts must equal rl-ppo's bit for bit and whose every
     rollout leaf must land on cuda in the driver; and rl-dreamer,
     train_dreamer on CartPole at tests/test_rl.py's DreamerConfig for 22
     episodes, its world-model and actor-critic update ms.
  11. Tune and Workflows (cluster_anywhere_tpu_torch.tune, .workflow), on a
     session of the port's runtime of their own: tune-asha, a Tuner over 4
     learning rates (the train cell's among them) with ASHA (max_t 12,
     grace 3, reduction 2), 4 trial actors at 0.25 GPU at once, each
     training the flagship from seed 0 on the train cell's batch (the
     configs the generator's own, a trial stopped before step 12, step 1's
     loss at the train cell's rate to 1e-6 of phase 5's, every step
     launching all three kernels inside its trial); tune-pbt, 2 trials at
     0.5 GPU under PopulationBasedTraining (interval 4, 8 steps), the
     trailing trial exploiting the leader's checkpoint of params and AdamW
     state (its restored params sha256-equal to the source checkpoint's,
     the loss falling); workflow-gpu, a num_gpus=1 step running the
     generate cell (its tokens equal to phase 3's or a near-tie) and a CPU
     step failing once, which workflow.resume finishes without running
     the GPU step again.  Under one watchdog; the driver launches nothing.
  12. the operator's surface (cluster_utils, util.chaos, jobs, autoscaler,
     dashboard, cli), each cell on a session of its own, under one
     watchdog: ops-up-job, `python -m cluster_anywhere_tpu_torch.cli up`
     of a YAML (a head of 2 CPUs and no GPU, one node of 2 CPUs and 1 GPU),
     `ca status`, `ca list nodes` and the dashboard's /api/nodes showing
     the GPU on that node alone, `ca submit -- python job.py` of a job
     script written here that imports only the port and runs the generate
     cell in a num_gpus=1 actor (SUCCEEDED in `ca jobs` and
     /api/jobs/<id>; the tokens, read from its logs through
     JobSubmissionClient, equal to phase 3's or differing on a near-tie;
     the forward launched in the actor, nothing in the job's driver, which
     sees no card), `ca down` leaving no process; ops-autoscale, a Cluster
     whose head has no GPU under Autoscaler(AgentNodeProvider()) with one
     node type {CPU: 2, GPU: 1}: a num_gpus=1 actor's demand launches the
     node, the actor runs the generate cell there (the same checks), and
     the node is terminated within idle_timeout_s + 10 s of the actor's
     kill; ops-preempt, a Cluster of two nodes of one GPU each (sharing the
     card) under TorchTrainer, 2 workers (min 1) on fsdp2 over TorchConfig's
     gloo group, max_failures 0, training the flagship on the train cell's
     batch for 12 steps, with PreemptionSimulator warning rank 1's node
     after step 3: the barrier checkpoint, one budget-exempt restart at
     world 1 on the survivor loading it, every step 1-12 reported (at most
     2 run again), each loss within 1e-3 relative of the one-device run's
     on the same weights and batch (world 2 from seed 0, world 1 from the
     checkpoint it loaded), all three kernels launched in the
     workers and none in the driver.  No process of a session is left.
  13. `ca lint` and `ca microbenchmark --dag` (analysis/, microbenchmark.py),
     under one watchdog of 75 s: `python -m cluster_anywhere_tpu_torch.cli
     lint --format json` in a subprocess (exit 0, no finding; the count of
     findings and of the contract's methods printed), then the port's
     run_dag_plane(quick=True) on the card (its rows printed: actor-call
     latency and throughput over RPC and the compiled DAG, TTFT p50 and
     p99 of each serve arm), its replica's class swapped for the counting
     ingress from here: both arms (streaming RPC, the compiled stream)
     answer all 10 requests (2 warm-up, 8 timed) with HTTP 200 and equal
     event counts (greedy decoding), the compiled arm's on the compiled
     stream, and each replica launches the forward on the card.
The kernels' launch counts are zeroed just before phases 3-5 (the main
path) and read just after, and again around each MoE cell: serving
launches no backward kernel, and every training step launches 8 of each
kernel; the HTTP and processor cells launch nothing in the driver.
Prints whether pyarrow and pandas import (the Data library needs
neither), a `kernels` JSON line (launches summed over all cells, the
replica's, the processor actor's, the parallel ranks', the Train
workers', the Prefiller's, the RPC wave replica's, the Tune trials', the
workflow step's, phase 12's actors' and workers' and phase 13's replicas'
included), the
card's name and power limit, and as its last line
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
TRAIN_LR = 3e-4  # make_train_step's default rate: the train cell's
STEP1_LOSS = {}  # each training cell's step-1 loss, by its tag (phase 11 reads "train")
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


# The attention blocks the parallel cells (phase 7) give the kernels, held
# to the plain versions in phases 1 and 5: (name, B, T = T_kv, H, causal,
# LSE cotangent).  Ring attention at T_local 1024 on a tp rank's 4 heads
# runs an earlier shard's block (not causal) and the diagonal (causal),
# each returning the LSE that merge_attention reads, so the backward gets
# an LSE cotangent; Ulysses runs the whole sequence on an sp rank's 2 heads.
PAR_ATTENTION_BLOCKS = (
    ("ring past block B4 T1024 H4 D128 not causal", 4, 1024, 4, False, True),
    ("ring diagonal block B4 T1024 H4 D128 causal", 4, 1024, 4, True, True),
    ("ulysses B4 T2048 H2 D128 causal", 4, 2048, 2, True, False),
)


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
    for name, b, t, h, causal, _ in PAR_ATTENTION_BLOCKS:
        q, k, v = (torch.randn((b, t, h, 128), generator=gen, device="cuda").bfloat16()
                   for _ in range(3))
        compare(name, q, k, v, causal, None, "bfloat16")
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


def gpu_clocks(query="clocks.sm,clocks.max.sm"):
    """The SM clock and its maximum (or another query), as nvidia-smi reads
    them now."""
    smi = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
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
    for name, b, t, h, causal, with_dlse in PAR_ATTENTION_BLOCKS:
        q, k, v, do = (torch.randn((b, t, h, 128), generator=gen, device="cuda").bfloat16()
                       for _ in range(4))
        compare(name, q, k, v, do, causal, None, "bfloat16", with_dlse)
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
    ids_t, lens_t = generate_prompts(torch, cfg, 0, "cuda")
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


def token_stream(items, gaps=None):
    """(seconds to the first item, the token ids) of a stream of
    {"token_id", "text"} items; the seconds between consecutive items are
    appended to `gaps` when it is given."""
    t0, first, toks = time.perf_counter(), None, []
    last = t0
    for item in items:
        now = time.perf_counter()
        first = now - t0 if first is None else first
        if gaps is not None and toks:
            gaps.append(now - last)
        last = now
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
    """The SSE ingress that build_continuous_llm_deployment deploys, its
    dag_stream handshakes counted, plus one method that reads the
    replica's own process: its pid, the GPU it holds, the forward kernel's
    launch count (reset on request), the library it loaded and the
    handshakes.  Defined in a function, so it travels by value to the
    replica's worker."""
    from cluster_anywhere_tpu_torch.llm.serve_llm import StreamingLLMIngress

    class CountingIngress(StreamingLLMIngress):
        handshakes = 0  # dag_stream calls: SSE requests on the compiled stream

        def dag_stream(self, request):
            self.handshakes += 1
            return super().dag_stream(request)

        def probe(self, reset=False):
            import os

            import torch

            from cluster_anywhere_tpu_torch.ops import _build
            from cluster_anywhere_tpu_torch.ops.attention import flash_attention

            dev = self.cb.params.device
            card = dev.type == "cuda"  # a host rehearsal's replica has none
            out = {"pid": os.getpid(), "launches": flash_attention.launches,
                   "visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "params": str(dev),
                   "gpu": torch.cuda.get_device_name(dev) if card else "cpu",
                   "allocated_gb": torch.cuda.memory_allocated(dev) / 1e9 if card else 0.0,
                   "lib": str(_build.build("flash_fwd")) if card else None,
                   "handshakes": self.handshakes}
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
    process, the proxy on a port the OS picks, SSE on the compiled shm
    stream (serve_compiled_dag, the default: the handshakes counted in the
    replica, no fallback to streaming RPC in the proxy).  Returns the
    replica's forward launches, read inside the replica, and the first SSE
    wave's TTFTs and token inter-arrival times (s)."""
    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch import serve
    from cluster_anywhere_tpu_torch.core import api
    from cluster_anywhere_tpu_torch.core.config import get_config
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
        proxy = ca.get_actor(serve.PROXY_NAME)
        streams_before = ca.get(proxy.stream_stats.remote(), timeout=60)
        zero_launch_counts(attn)
        gaps = []

        # SSE first: a fresh replica's first wave, as the in-process cell's
        # fresh server (one prefix miss, seven hits), so their TTFTs compare
        def sse(i, gaps=None):
            return token_stream(sse_events(url, {"prompt": prompts[i]}), gaps)

        streams, sse_wall = in_threads(lambda i: sse(i, gaps), B)
        answers, wall = in_threads(lambda i: http_post(url, {"prompt": prompts[i]}), B)
        # and SSE again on the warm replica: what the first wave's start costs
        warm, warm_wall = in_threads(sse, B)
        after = handle.options(method_name="probe").remote().result(timeout_s=60)
        driver_launches = launch_counts(attn)
        streams_after = ca.get(proxy.stream_stats.remote(), timeout=60)
        opened = {k: streams_after[k] - streams_before[k] for k in ("dag", "rpc", "fallbacks")}
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
        check(after["handshakes"] >= 2 * B and opened == {"dag": 2 * B, "rpc": 0, "fallbacks": 0}
              and not streams_after["failed_deployments"],
              f"the SSE streams did not all take the compiled shm stream: {after['handshakes']} "
              f"dag_stream handshakes in the replica, the proxy's streams {opened}, "
              f"{streams_after}")
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
        log(f"[serve-http] SSE transport: the compiled shm stream (serve_compiled_dag="
            f"{get_config().serve_compiled_dag}): {after['handshakes']} dag_stream handshakes in "
            f"the replica, the proxy opened {opened}; the first wave's token inter-arrival p50 "
            f"{np.median(gaps) * 1e3:.2f} ms, max {max(gaps) * 1e3:.2f} ms over {len(gaps)} gaps")
        pids = [w["pid"] for w in state.list_workers()] + [api._head_proc.pid]
    finally:
        serve.shutdown()
        ca.shutdown()
    wait_gone(pids, "the port's session")
    log(f"[serve-http] serve.shutdown() and ca.shutdown(): none of {len(pids)} processes "
        f"(head and workers) left")
    return after["launches"], {"ttft": ttft, "gaps": gaps}


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


def wait_gone(pids, session):
    """Waits up to 30 s for a session's processes to end after its
    shutdown; fails the phase if one is left.  Returns the s it took."""
    t0 = time.perf_counter()
    deadline = time.monotonic() + 30
    alive = list(pids)
    while alive and time.monotonic() < deadline:
        alive = [p for p in alive if _pid_alive(p)]
        if alive:
            time.sleep(0.1)
    check(not alive, f"processes of {session} still alive after shutdown: {alive}")
    return time.perf_counter() - t0


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
    the cell's launches (fwd, dQ, dK/dV), step 1's loss and the step ms."""
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
    return launches, losses[0], step_ms


def phase_data(torch, attn, cfg, train_ms):
    """The processor and train-data cells on one session of the port's
    runtime (ca.init detects the GPU); no process of it left after
    shutdown.  Returns their launches (fwd, dQ, dK/dV), the actor's
    included, and the train-data cell's step 1 loss and step ms."""
    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch.core import api
    from cluster_anywhere_tpu_torch.util import state

    torch.cuda.empty_cache()
    info = ca.init(num_cpus=4)
    try:
        check(info["resources"].get("GPU") == 1.0,
              f"the runtime detected {info['resources'].get('GPU')} GPUs, want 1")
        actor_fwd = phase_processor(torch, attn, cfg)
        train, train_loss, train_data_ms = phase_train_data(torch, attn, cfg, train_ms)
        pids = [w["pid"] for w in state.list_workers()] + [api._head_proc.pid]
    finally:
        ca.shutdown()
    wait_gone(pids, "the port's session")
    return (train[0] + actor_fwd,) + train[1:], train_loss, train_data_ms


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
    STEP1_LOSS[tag] = losses[0]
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


# ----------------------------------------------------------------- phase 7
# The parallel stack: 4 ranks share the one H100 over gloo (NCCL refuses two
# ranks on one device), spawned once, each cell on a fresh mesh.  Step
# times are of 4 ranks sharing one card: not a scaling number.

PAR_WORLD = 4
PAR_TIMED = 3  # steps timed after the first (warm-up and compared) step
PAR_LAYERS = 4  # the flagship's depth cut from 8, the widths kept: the script's time limit
PAR_CELLS = (  # (name, config overrides, mesh axes, B, T, reference)
    ("par-A-pp2-tp2", dict(pp=2, num_microbatches=2), dict(pp=2, tp=2), 8, 1024, "dense"),
    ("par-B-ring-sp2-tp2", dict(sp=2, attn_impl="ring"), dict(sp=2, tp=2), 4, 2048, "dense-2048"),
    ("par-B-ulysses-sp4", dict(sp=4, attn_impl="ulysses"), dict(sp=4), 4, 2048, "dense-2048"),
    ("par-C-ep2-dp2", dict(ep=2), dict(dp=2, ep=2), 8, 1024, "moe"),
    ("par-D-pp2-ep2", dict(ep=2, pp=2, num_microbatches=2), dict(pp=2, ep=2), 8, 1024, "moe"),
    ("par-E-fsdp2-tp2", dict(), dict(fsdp=2, tp=2), 8, 1024, "dense"),
)
# A capacity factor at which no token is dropped, in an ep group or on one
# device, so the one-device reference computes the same function (JAX's
# default 1.25 is held against JAX in tests/test_torch_parallel_model.py).
# The other difference is the load-balance aux: a sharded MoE step takes
# it per routing group (each ep group of rows, and each microbatch of it
# through the pipeline), meaned over the groups, as JAX's shard_map does;
# the reference takes its aux over the same groups (par_grouped_aux).
PAR_CAPACITY = 4.0
PAR_CELL_DEADLINE_S = 300
PAR_TOL = {"loss_rel": 1e-3, "grad_rel_l2": 5e-2}  # phase 5's gradient bound


def par_base_cfg(ref):
    if ref == "moe":
        return dataclasses.replace(moe_flagship(), capacity_factor=PAR_CAPACITY,
                                   n_layers=PAR_LAYERS)
    return dataclasses.replace(flagship(), n_layers=PAR_LAYERS)


def par_batch(torch, cfg, b, t):
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, t + 1))
    return torch.from_numpy(ids).cuda()


def par_ref_dir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "parallel_ref")


def par_ref_key(cell):
    """The reference a cell is held to: its batch, and for MoE the number
    of routing groups its aux is meaned over."""
    _, over, axes, b, t, ref = cell
    if ref != "moe":
        return f"{ref}-B{b}-T{t}"
    micro = over.get("num_microbatches", 1) if over.get("pp", 1) > 1 else 1
    return f"{ref}-B{b}-T{t}-{axes.get('ep', 1) * micro}groups"


@contextlib.contextmanager
def par_grouped_aux(torch, groups):
    """Inside, the model's MoE aux is the mean over `groups` equal runs of
    tokens (in flat order) of each run's own aux, what the sharded step
    computes; outputs and routes are the one-device moe_ffn's."""
    from cluster_anywhere_tpu_torch.models import transformer as tf

    real = tf.moe_ffn

    def grouped(x, router_w, w_in, w_out, **kw):
        r = real(x, router_w, w_in, w_out, **kw)
        probs = torch.softmax(x @ router_w, dim=-1).reshape(groups, -1, router_w.shape[1])
        onehot = probs.argmax(dim=-1)[..., None] == torch.arange(router_w.shape[1],
                                                                 device=x.device)
        aux = (onehot.to(probs.dtype).mean(dim=1) * probs.mean(dim=1)).sum(dim=-1).mean()
        return r._replace(aux_loss=aux * router_w.shape[1])

    tf.moe_ffn = grouped
    try:
        yield
    finally:
        tf.moe_ffn = real


def par_references(torch):
    """Each reference once on the card, one device (make_loss_fn with the
    kernels; a MoE model's aux over the sharded step's routing groups):
    step 1's loss and every gradient, and the MoE routes, saved under
    build/parallel_ref/ for the ranks; nothing of it stays on the card."""
    import gc

    from cluster_anywhere_tpu_torch.models import init_params, make_loss_fn, to_jax_params

    os.makedirs(par_ref_dir(), exist_ok=True)
    for key, ref, b, t in sorted({(par_ref_key(c), c[5], c[3], c[4]) for c in PAR_CELLS}):
        cfg = par_base_cfg(ref)
        model = init_params(cfg, 0, device="cuda")
        routes = []
        groups = int(key.split("-")[-1][:-len("groups")]) if ref == "moe" else 1
        with moe_routes(routes), par_grouped_aux(torch, groups):
            loss = make_loss_fn(cfg)(model, {"ids": par_batch(torch, cfg, b, t)})
            loss.backward()
        grads = to_jax_params(model, grads=True)
        torch.save({"loss": loss.item(), "grads": grads}, os.path.join(par_ref_dir(), f"{key}.pt"))
        torch.save([r.cpu() for r in routes], os.path.join(par_ref_dir(), f"{key}.routes.pt"))
        log(f"[parallel] reference {key} (one device): loss {loss.item():.6f}, "
            f"{len(routes)} route calls")
        del model, loss, routes, grads
        gc.collect()
        torch.cuda.empty_cache()


def par_pinned_routes(torch, cfg, mesh, ref_routes, b, t):
    """This rank's share of the reference's routes, in the order its
    moe_ffn calls come: layer by layer, and for a pipeline stage its
    microbatches in turn, each over its layers."""
    from cluster_anywhere_tpu_torch.models import transformer as tf
    from cluster_anywhere_tpu_torch.parallel.mesh import axis_index

    plan = tf._Plan(cfg, mesh)
    rows = plan.local_ids(torch.arange(b)[:, None])[:, 0].reshape(plan.micro, -1)
    layers = range(cfg.n_layers)
    if cfg.pp > 1:
        first = axis_index(mesh, "pp") * cfg.layers_per_stage
        layers = range(first, first + cfg.layers_per_stage)
    return [ref_routes[layer].reshape(b, t)[mb].reshape(-1).cuda()
            for mb in rows for layer in layers]


def par_probe(torch, rank):
    """Each collective of the tensor plane on a CUDA tensor over the 4
    ranks, held to its value, and quantized_psum's int8 error on a
    flagship-sized gradient (wq, 1024 x 1024) within sum_r scale_r / 2."""
    from cluster_anywhere_tpu_torch.parallel import collectives as col
    from cluster_anywhere_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    mesh = make_mesh(MeshSpec(dp=PAR_WORLD), device="cuda", backend="gloo")
    tp = col.tensor_plane
    x = torch.arange(8, device="cuda", dtype=torch.float32) + 10 * rank
    n = PAR_WORLD
    ranks = torch.arange(n, device="cuda", dtype=torch.float32)
    got = {
        "allreduce": torch.equal(tp.allreduce(x, mesh, "dp"),
                                 torch.arange(8, device="cuda") * n + 10 * ranks.sum()),
        "allgather": torch.equal(tp.allgather(x, mesh, "dp"),
                                 (torch.arange(8, device="cuda")[None] + 10 * ranks[:, None])
                                 .reshape(-1)),
        "reducescatter": torch.equal(tp.reducescatter(torch.ones(2 * n, device="cuda"), mesh, "dp"),
                                     torch.full((2,), float(n), device="cuda")),
        "all_to_all": torch.equal(tp.all_to_all(torch.full((n,), float(rank), device="cuda"),
                                                mesh, "dp", 0, 0), ranks),
        "permute": torch.equal(tp.permute(x, mesh, "dp", [(i, (i + 1) % n) for i in range(n)]),
                               torch.arange(8, device="cuda") + 10 * ((rank - 1) % n)),
    }
    gen = torch.Generator(device="cuda").manual_seed(rank)
    g = torch.randn(1024, 1024, generator=gen, device="cuda") * 0.01
    exact = tp.allreduce(g, mesh, "dp")
    q = col.quantized_psum(g, mesh, "dp", "int8", 2048)
    _, scale = col.quantize_int8(g, 2048)
    bound = tp.allgather(scale, mesh, "dp", tiled=False).sum(dim=0) / 2  # per block
    err = (q - exact).abs().reshape(-1, 2048).amax(dim=1)
    worst = int((err / bound).argmax())
    staged = {k: k in col.HOST_STAGED.get("gloo", ()) for k in col.KINDS}
    return {"values": got, "staged": staged, "int8_err": err[worst].item(),
            "int8_bound": bound[worst].item(), "int8_ok": bool((err <= bound + 1e-6).all())}


def par_cell(torch, attn, rank, cell):
    """One cell on this rank: a fresh mesh, the flagship (or its MoE
    variant) from seed 0, one compared step and PAR_TIMED timed ones."""
    from cluster_anywhere_tpu_torch.models import make_loss_fn, make_train_step, to_jax_params
    from cluster_anywhere_tpu_torch.parallel import collectives as col
    from cluster_anywhere_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    name, over, axes, b, t, ref = cell
    cfg = dataclasses.replace(par_base_cfg(ref), **over)
    mesh = make_mesh(MeshSpec(**axes), device="cuda", backend="gloo")
    step, init_state = make_train_step(cfg, mesh)
    model, opt = init_state(0)
    batch = {"ids": par_batch(torch, cfg, b, t)}
    routes, agree = [], None
    if cfg.n_experts:
        routes = par_pinned_routes(torch, cfg, mesh, torch.load(
            os.path.join(par_ref_dir(), f"{par_ref_key(cell)}.routes.pt")), b, t)
        # the sharded router on its own, on the same weights, held beside
        # the reference's routes (the compared step below pins them)
        own = []
        with torch.no_grad(), moe_routes(own):
            make_loss_fn(cfg, mesh)(model, batch)
        agree = (route_agreement(own, routes), sum(r.numel() for r in own))
    zero_launch_counts(attn)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with moe_routes(routes, pin=True):
        _, _, loss = step(model, opt, batch)
    losses = [loss.item()]
    grads = to_jax_params(model, grads=True)
    out = {"rank": rank, "agree": agree}
    if rank == 0:
        refs = torch.load(os.path.join(par_ref_dir(), f"{par_ref_key(cell)}.pt"),
                          weights_only=False)
        worst_rel, worst_cos = (0.0, ""), (1.0, "")
        want = refs["grads"]
        for key in ("embed", "ln_f", "lm_head", *want["blocks"]):
            gk = grads[key] if key in grads else grads["blocks"][key]
            gw = want[key] if key in want else want["blocks"][key]
            gk = torch.from_numpy(gk).double().reshape(gw.shape)
            gw = torch.from_numpy(gw).double()
            rel = ((gk - gw).norm() / gw.norm()).item()
            cos = (gk.flatten() @ gw.flatten() / (gk.norm() * gw.norm())).item()
            worst_rel, worst_cos = max(worst_rel, (rel, key)), min(worst_cos, (cos, key))
        out.update(ref_loss=refs["loss"], worst_rel=worst_rel, worst_cos=worst_cos)
        del refs, want
    del grads
    col.counts.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PAR_TIMED):
        _, _, loss = step(model, opt, batch)
        losses.append(loss.item())  # ends in a synchronize
    step_ms = (time.perf_counter() - t0) / PAR_TIMED * 1e3
    out.update(losses=losses, step_ms=step_ms, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=launch_counts(attn),
               moved={k: v / PAR_TIMED for k, v in col.counts.moved.items()},
               staged=col.counts.staged / PAR_TIMED)
    del model, opt, step
    torch.cuda.empty_cache()
    return out


def par_rank(rank, port, cells, results):
    """A rank's life: join the group, the probe, then the cells in turn,
    each result (or the traceback) put on `results`."""
    import datetime
    import faulthandler
    import traceback

    faulthandler.dump_traceback_later(PAR_CELL_DEADLINE_S * len(cells), exit=True)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(PAR_WORLD), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    try:
        import importlib

        import torch
        import torch.distributed as dist

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=PAR_CELL_DEADLINE_S))
        attn = importlib.import_module("cluster_anywhere_tpu_torch.ops.attention")
        results.put(("probe", rank, par_probe(torch, rank)))
        for cell in cells:
            results.put((cell[0], rank, par_cell(torch, attn, rank, cell)))
        dist.destroy_process_group()
    except Exception:  # reported to the parent, which fails the phase
        results.put(("error", rank, traceback.format_exc()))


def phase_parallel(torch, attn):
    """The parallel stack's cells on 4 ranks sharing the card over gloo.
    Returns the ranks' kernel launches (fwd, dQ, dK/dV) summed."""
    import multiprocessing as mp
    import queue
    import socket

    par_references(torch)
    log(f"[parallel] this process's card memory before the ranks start: "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=par_rank, args=(r, port, PAR_CELLS, results), daemon=True)
             for r in range(PAR_WORLD)]
    for p in procs:
        p.start()
    launches = (0, 0, 0)
    try:
        for cell in ("probe",) + tuple(c[0] for c in PAR_CELLS):
            got = {}
            end = time.monotonic() + PAR_CELL_DEADLINE_S
            while len(got) < PAR_WORLD:
                try:
                    tag, rank, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [p.exitcode for p in procs if p.exitcode is not None]
                    check(not dead, f"[parallel] a rank exited (codes {dead}) during {cell}")
                    check(time.monotonic() < end, f"[parallel] {cell} passed its "
                          f"{PAR_CELL_DEADLINE_S} s deadline; ranks done: {sorted(got)}")
                    continue
                check(tag != "error", f"[parallel] rank {rank} failed:\n{value}")
                check(tag == cell, f"[parallel] rank {rank} sent {tag} while {cell} ran")
                got[rank] = value
            if cell == "probe":
                launches = par_report_probe(got)
            else:
                launches = tuple(a + b for a, b in zip(launches, par_report_cell(cell, got)))
    finally:
        for p in procs:
            p.join(30)
            if p.is_alive():
                p.kill()
                p.join(5)
    log(f"[parallel] launches inside the ranks, all cells (fwd, dQ, dK/dV): {launches}")
    return launches


def par_report_probe(got):
    values = {k: all(got[r]["values"][k] for r in got) for k in got[0]["values"]}
    staged = got[0]["staged"]
    log(f"[parallel] probe, 4 ranks on one card over gloo, CUDA tensors: collectives right "
        f"{values}; gloo runs directly {[k for k, v in staged.items() if not v]}, the "
        f"collectives module stages through pinned host memory {[k for k, v in staged.items() if v]}")
    q = got[0]
    log(f"[parallel] quantized_psum int8 on a flagship wq gradient (1024 x 1024, blocks of 2048): "
        f"in the block nearest its bound, max |int8 - exact psum| {q['int8_err']:.6g} against "
        f"sum_r scale_r / 2 = {q['int8_bound']:.6g}")
    check(all(values.values()), f"[parallel] a collective gave a wrong value on CUDA: {values}")
    check(all(got[r]["int8_ok"] for r in got), "[parallel] quantized_psum int8 exceeds its bound")
    return (0, 0, 0)


def par_report_cell(cell, got):
    r0 = got[0]
    losses = r0["losses"]
    loss_rel = abs(losses[0] - r0["ref_loss"]) / abs(r0["ref_loss"])
    step_ms = max(g["step_ms"] for g in got.values())
    moved = {}
    for g in got.values():
        for k, v in g["moved"].items():
            moved[k] = moved.get(k, 0) + v
    staged = sum(g["staged"] for g in got.values())
    launches = tuple(map(sum, zip(*(g["launches"] for g in got.values()))))
    peaks = " ".join(f"{got[r]['peak_gb']:.2f}" for r in sorted(got))
    log(f"[{cell}] 4 ranks sharing one H100 over gloo: step {step_ms:.2f} ms (slowest rank, "
        f"{PAR_TIMED} steps after 1 warm-up; not a scaling number), peak memory per rank "
        f"{peaks} GB; loss over "
        f"{len(losses)} steps {' '.join(f'{x:.4f}' for x in losses)}; step 1 vs one device "
        f"{losses[0]:.6f} vs {r0['ref_loss']:.6f} (relative {loss_rel:.3g}); worst gradient "
        f"relative L2 {r0['worst_rel'][0]:.4g} ({r0['worst_rel'][1]}), lowest cosine "
        f"{r0['worst_cos'][0]:.6f} ({r0['worst_cos'][1]}); tolerances {PAR_TOL}")
    log(f"[{cell}] bytes a step, all ranks, by collective: "
        f"{ {k: int(v) for k, v in sorted(moved.items())} }; staged through host memory "
        f"{int(staged)}; kernel launches in the ranks (fwd, dQ, dK/dV) {launches}")
    if r0["agree"] is not None:
        n = sum(g["agree"][1] for g in got.values())
        share = sum(g["agree"][0] * g["agree"][1] for g in got.values()) / n
        log(f"[{cell}] the sharded router on its own (step 1's weights, routes unpinned): "
            f"{share:.6f} of {n} routes agree with the one-device reference's (the compared step "
            f"pins them; bf16 routes flip on near-ties)")
    check(loss_rel <= PAR_TOL["loss_rel"], f"[{cell}] step 1's loss is off the reference's")
    check(r0["worst_rel"][0] <= PAR_TOL["grad_rel_l2"], f"[{cell}] a gradient is off the reference's")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"[{cell}] loss did not fall: {losses}")
    check(all(n > 0 for n in launches), f"[{cell}] a kernel did not launch in the ranks: {launches}")
    return launches


# ----------------------------------------------------------------- phase 8
# The Train library: TorchTrainer(...).fit() from GPU workers that the
# runtime starts, on a session of its own.  The loops are closures (they
# travel to the workers by value: no package module holds a train loop).

TL_STEPS, TL_CKPT_EVERY, TL_FAIL_AFTER = 12, 6, 9  # train-lib: steps, save after 6 and 12, fail after 9
TL_LAYERS = 4  # the Train cells' depth, cut from the flagship's 8 with the widths kept: the time limit
TL_FSDP_STEPS, TL_FSDP_CKPT = 5, 4  # train-lib-fsdp: steps, the sharded save after step 4
TL_DEADLINE_S = 900  # the whole phase, under one watchdog
HOST_PROBE_WORLD, HOST_PROBE_REPS = 4, 5
TL_TOL = {"step1_rel": 1e-6, "resume_rel": 1e-6, "reshard_rel": 1e-3}


def train_lib_loops():
    """(one-device loop, sharded loop) for TorchTrainer, nested so that
    they travel by value.  Both report every step's loss, step ms and the
    flash kernels' launches counted inside the worker; the one-device loop
    resumes from train.get_checkpoint() (Checkpoint.save_pytree of
    models.train_state) and can fail once after a given step (a marker
    file in config); the sharded loop builds its mesh on the torch.distributed
    group TorchConfig made and saves with save_pytree_sharded."""

    def launches():
        import importlib

        attn = importlib.import_module("cluster_anywhere_tpu_torch.ops.attention")
        return (attn.flash_attention.launches, attn.flash_bwd_dq.launches,
                attn.flash_bwd_dkv.launches)

    def digest(tree):
        import hashlib

        from cluster_anywhere_tpu_torch.train.checkpoint import tree_flatten

        h = hashlib.sha256()
        for leaf in tree_flatten(tree)[0]:
            h.update(leaf.detach().cpu().numpy().tobytes() if hasattr(leaf, "detach")
                     else leaf.tobytes())
        return h.hexdigest()

    def single(config):
        import os
        import shutil
        import time

        import torch

        from cluster_anywhere_tpu_torch import train
        from cluster_anywhere_tpu_torch.models import load_train_state, make_train_step, train_state

        t_start = time.time()
        torch.backends.cuda.matmul.allow_tf32 = False
        ctx = train.get_context()
        cfg, dev = config["cfg"], config["device"]
        step, init_state = make_train_step(cfg, device=dev)
        model, opt = init_state(config["seed"])
        start, load_s = 0, 0.0
        ck = train.get_checkpoint()
        if ck is not None:
            t0 = time.perf_counter()
            tree = ck.load_pytree()
            load_train_state(model, opt, tree)
            start = int(tree["opt"]["count"])
            load_s = time.perf_counter() - t0
        shard = train.get_dataset_shard("train")

        def batches():
            while True:  # epochs: 88 rows give 11 batches of 8
                for b in shard.iter_torch_batches(batch_size=config["batch_size"], device=dev):
                    yield b["data"]

        it = batches()
        for _ in range(start):  # the data position of the checkpoint's step
            next(it)
        build_s = time.time() - t_start
        for s in range(start + 1, config["steps"] + 1):
            ids = next(it)
            before = launches()
            t0 = time.perf_counter()
            _, _, loss = step(model, opt, {"ids": ids})
            loss = loss.item()  # ends in a synchronize
            step_ms = (time.perf_counter() - t0) * 1e3
            metrics = {"step": s, "loss": loss, "step_ms": step_ms, "attempt": ctx.attempt,
                       "launches": [a - b for a, b in zip(launches(), before)],
                       "t_start": t_start, "build_s": build_s, "load_s": load_s}
            ckpt = None
            if s % config["ckpt_every"] == 0:
                ckpt = train.Checkpoint(train.make_temp_checkpoint_dir())
                t0 = time.perf_counter()
                ckpt.save_pytree(train_state(model, opt))
                metrics["save_ms"] = (time.perf_counter() - t0) * 1e3
                metrics["save_bytes"] = os.path.getsize(os.path.join(ckpt.path, "state.npz"))
            t0 = time.perf_counter()
            train.report(metrics, checkpoint=ckpt)
            if ckpt is not None:
                metrics["report_ms"] = (time.perf_counter() - t0) * 1e3
                shutil.rmtree(ckpt.path)
                train.report({"step": s, "report_ms": metrics["report_ms"], "attempt": ctx.attempt})
            if s == config.get("fail_after") and not os.path.exists(config["marker"]):
                with open(config["marker"], "w") as f:
                    f.write(repr(time.time()))
                raise RuntimeError(f"injected failure after step {s}")
        train.report({"done": True, "params_sha256": digest(train_state(model, opt)["params"]),
                      "attempt": ctx.attempt})

    def sharded(config):
        import time

        import torch
        import torch.distributed as dist

        from cluster_anywhere_tpu_torch import train
        from cluster_anywhere_tpu_torch.models import (load_train_state, make_train_step, train_state,
                                                       train_state_specs)
        from cluster_anywhere_tpu_torch.parallel.mesh import MeshSpec, make_mesh, mesh_device

        t_start = time.time()
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg, dev = config["cfg"], config["device"]
        mesh = make_mesh(MeshSpec(**config["axes"]), device=dev, backend="gloo")
        step, init_state = make_train_step(cfg, mesh)
        model, opt = init_state(config["seed"])
        specs = train_state_specs(cfg)
        start = 0
        ck = train.get_checkpoint()
        if ck is not None:
            load_train_state(model, opt, ck.load_pytree_sharded(mesh=mesh, specs=specs))
            start = int(float(opt.state[model.embed]["step"]))
        ids = torch.tensor(config["ids"], device=mesh_device(mesh))  # every rank: the whole batch
        build_s = time.time() - t_start
        for s in range(start + 1, config["steps"] + 1):
            before = launches()
            t0 = time.perf_counter()
            _, _, loss = step(model, opt, {"ids": ids})
            loss = loss.item()
            step_ms = (time.perf_counter() - t0) * 1e3
            got = torch.tensor([a - b for a, b in zip(launches(), before)], dtype=torch.int64)
            dist.all_reduce(got)  # every rank's launches, summed (only rank 0's reports count)
            metrics = {"step": s, "loss": loss, "step_ms": step_ms, "launches": got.tolist(),
                       "world": dist.get_world_size(), "build_s": build_s}
            ckpt = None
            if s == config.get("ckpt_at"):
                ckpt = train.Checkpoint(train.shared_checkpoint_dir(s))
                t0 = time.perf_counter()
                ckpt.save_pytree_sharded(train_state(model, opt), mesh=mesh, specs=specs)
                dist.barrier()
                metrics["save_ms"] = (time.perf_counter() - t0) * 1e3
            train.report(metrics, checkpoint=ckpt)

    return single, sharded


def tl_run(loop, config, scaling, storage, name, **kw):
    """One TorchTrainer fit; returns (result, wall s, fit start on the
    host's clock)."""
    from cluster_anywhere_tpu_torch import train

    t0 = time.time()
    result = train.TorchTrainer(
        loop, train_loop_config=config, scaling_config=scaling,
        run_config=train.RunConfig(name=name, storage_path=storage,
                                   checkpoint_config=kw.pop("checkpoint_config", None)
                                   or train.CheckpointConfig(),
                                   failure_config=kw.pop("failure_config", None)
                                   or train.FailureConfig()),
        **kw).fit()
    return result, time.time() - t0, t0


def tl_steps(history, attempt=None):
    """The step reports of a metrics history (of one attempt)."""
    return [m for m in history if "loss" in m and (attempt is None or m.get("attempt") == attempt)]


def tl_single_cells(cfg, ids, device, use_gpu, storage):
    """The train-lib cell: one fit of TL_STEPS steps (saves after every
    TL_CKPT_EVERY, keep 2), then the same fit failing once after
    TL_FAIL_AFTER steps, which the controller restarts from the last
    checkpoint.  Returns what the checks and logs need."""
    import cluster_anywhere_tpu_torch.data as cad
    from cluster_anywhere_tpu_torch import train

    single, _ = train_lib_loops()
    marker = os.path.join(storage, "fail_once")
    config = {"cfg": cfg, "device": device, "seed": 0, "steps": TL_STEPS, "batch_size": TRAIN_B,
              "ckpt_every": TL_CKPT_EVERY, "marker": marker}
    scaling = train.ScalingConfig(num_workers=1, use_gpu=use_gpu)
    keep2 = train.CheckpointConfig(num_to_keep=2)
    first, first_s, first_t0 = tl_run(single, config, scaling, storage, "train-lib",
                                      datasets={"train": cad.from_numpy(ids)},
                                      checkpoint_config=keep2)
    again, again_s, _ = tl_run(single, dict(config, fail_after=TL_FAIL_AFTER), scaling, storage,
                               "train-lib-resume", datasets={"train": cad.from_numpy(ids)},
                               checkpoint_config=keep2,
                               failure_config=train.FailureConfig(max_failures=1))
    with open(marker) as f:
        t_fail = float(f.read())
    return {"first": first, "first_s": first_s, "first_t0": first_t0, "again": again,
            "again_s": again_s, "t_fail": t_fail}


def tl_fsdp_cells(cfg, ids, device, use_gpu, storage):
    """The train-lib-fsdp cell: 4 workers on one fsdp2 x tp2 mesh over a
    gloo group (TorchConfig), TL_FSDP_STEPS steps with save_pytree_sharded
    after TL_FSDP_CKPT; then 2 workers on an fsdp2 mesh resume from it
    (load_pytree_sharded: a reshard onto another world) and take the next
    step."""
    from cluster_anywhere_tpu_torch import train

    _, sharded = train_lib_loops()
    config = {"cfg": cfg, "device": device, "seed": 0, "steps": TL_FSDP_STEPS,
              "ckpt_at": TL_FSDP_CKPT, "ids": ids, "axes": {"fsdp": 2, "tp": 2}}
    four, four_s, _ = tl_run(sharded, config,
                             train.ScalingConfig(num_workers=4, use_gpu=use_gpu,
                                                 gpus_per_worker=0.25),
                             storage, "train-lib-fsdp",
                             backend_config=train.TorchConfig(backend="gloo"))
    two, two_s, _ = tl_run(sharded, dict(config, ckpt_at=None, axes={"fsdp": 2}),
                           train.ScalingConfig(num_workers=2, use_gpu=use_gpu, gpus_per_worker=0.5),
                           storage, "train-lib-fsdp-resume",
                           backend_config=train.TorchConfig(backend="gloo"),
                           resume_from_checkpoint=four.checkpoint)
    return {"four": four, "four_s": four_s, "two": two, "two_s": two_s}


def host_probe_rank_cls():
    """The host-group probe's actor class, nested so that it travels by value."""
    from cluster_anywhere_tpu_torch.parallel import collectives as coll

    class ProbeRank(coll.CollectiveActorMixin):
        def run(self, rank, n, shape, device, reps):
            import time

            import torch

            from cluster_anywhere_tpu_torch.parallel import collectives as coll

            g = coll.get_group()
            gen = torch.Generator(device=device).manual_seed(rank)
            x = torch.randn(*shape, generator=gen, device=device)
            ops = {
                "allreduce": lambda: coll.allreduce(x),
                "allreduce_int8": lambda: coll.allreduce(x, quantize="int8"),
                "allgather": lambda: coll.allgather(x),
                "reducescatter": lambda: coll.reducescatter(x),
                "broadcast": lambda: coll.broadcast(x, src_rank=0),
                # recv has no tensor to take a device from: it gives numpy
                "sendrecv": lambda: (coll.send(x, (rank + 1) % n), torch.from_numpy(
                    coll.recv((rank - 1) % n)).to(x.device))[1],
            }
            out, ms, sent = {}, {}, {}
            coll.barrier()  # the peers' addresses resolve here
            for name, op in ops.items():
                times = []
                for _ in range(reps):
                    coll.barrier()
                    b0 = g.sent_bytes
                    t0 = time.perf_counter()
                    got = op()
                    times.append((time.perf_counter() - t0) * 1e3)
                    sent[name] = g.sent_bytes - b0
                ms[name] = sorted(times)[len(times) // 2]
                got = got if isinstance(got, list) else [got]
                out[name] = {"device": str(got[0].device),
                             "value": [t.cpu().numpy() for t in got]}
            return {"x": x.cpu().numpy(), "out": out, "ms": ms, "sent": sent}

    return ProbeRank


def host_ring_reference(xs, quantize, block):
    """What the ring allreduce of xs (one array a rank) gives, op by op as
    P2PCollectiveGroup runs it (chunk c starts at rank c and gathers the
    ranks after it; int8 requantizes the partial sum at every hop and the
    reduced chunk once), and with int8 the per-element bound of the JAX
    docstring summed over those quantizations: max|block| / 254 each, plus
    the float rounding of the adds."""
    from cluster_anywhere_tpu_torch.parallel import collectives as coll

    n = len(xs)
    chunks = [np.array_split(x.reshape(-1).astype(np.float32), n) for x in xs]
    out, bound = [], []

    def q(a):
        payload, meta = coll.quantize_chunk(a, "int8", block)
        nb = -(-a.size // block)
        pad = np.zeros(nb * block, np.float32)
        pad[:a.size] = np.abs(a)
        step = np.repeat(pad.reshape(nb, block).max(axis=1) / 254, block)[:a.size]
        return coll.dequantize_chunk(payload, meta), step

    for c in range(n):
        acc, b = chunks[c][c], np.zeros(chunks[c][c].size, np.float32)
        for k in range(1, n):
            if quantize:
                acc, step = q(acc)
                b += step
            acc = chunks[(c + k) % n][c] + acc
        if quantize:
            acc, step = q(acc)
            b += step
        out.append(acc)
        bound.append(b)
    shape = xs[0].shape
    mag = sum(np.abs(x.astype(np.float64)) for x in xs).reshape(-1)
    return (np.concatenate(out).reshape(shape),
            (np.concatenate(bound) * (1 + 1e-5) + n * 2.0 ** -24 * mag).reshape(shape))


def host_group_probe(device):
    """4 actors in one "host" collective group (on the card: 0.25 GPU
    each), each op on a tensor of wq's size on `device`; every result held
    to the driver's own: f32 to the bit (the ring's order of adds
    replayed), int8 to the bit and within its bound.  Returns ({op: ms},
    {op: bytes a rank sent}, the int8 error and bound in the block nearest
    it)."""
    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch.core.config import get_config
    from cluster_anywhere_tpu_torch.parallel import collectives as coll

    n = HOST_PROBE_WORLD
    gpus = {"num_gpus": 0.25} if device == "cuda" else {}
    rank_cls = ca.remote(host_probe_rank_cls()).options(num_cpus=0.5, **gpus)
    ranks = [rank_cls.remote() for _ in range(n)]
    try:
        coll.create_collective_group(ranks, n, list(range(n)), backend="host")
        got = ca.get([r.run.remote(i, n, (1024, 1024), device, HOST_PROBE_REPS)
                      for i, r in enumerate(ranks)], timeout=600)
        coll.destroy_group_on(ranks)
    finally:
        for r in ranks:
            ca.kill(r)
    xs = [g["x"] for g in got]
    block = int(get_config().collective_quant_block)
    f32, _ = host_ring_reference(xs, None, block)
    int8, bound = host_ring_reference(xs, "int8", block)
    exact = sum(x.astype(np.float64) for x in xs)
    want = {"allreduce": [f32], "allreduce_int8": [int8], "allgather": xs,
            "reducescatter": None, "broadcast": [xs[0]], "sendrecv": None}
    for r, g in enumerate(got):
        out = g["out"]
        # each actor sees its card as device 0
        check(all(o["device"] == ("cuda:0" if device == "cuda" else device) for o in out.values()),
              f"[host-groups] rank {r} got results on {[o['device'] for o in out.values()]}")
        rs = np.array_split(f32.reshape(-1), n)[r]
        for name, values in out.items():
            w = {"reducescatter": [rs], "sendrecv": [xs[(r - 1) % n]]}.get(name, want[name])
            check(len(values["value"]) == len(w) and all(
                np.array_equal(a, b.reshape(a.shape)) for a, b in zip(values["value"], w)),
                  f"[host-groups] rank {r}: {name} differs from the driver's")
    err = np.abs(int8.astype(np.float64) - exact)
    check(bool((err <= bound).all()), "[host-groups] int8 allreduce exceeds its bound")
    worst = np.unravel_index(np.argmax(err / bound), err.shape)
    return got[0]["ms"], got[0]["sent"], float(err[worst]), float(bound[worst])


def phase_train_lib(torch, attn, ref):
    """The Train library's cells on a session of the port's runtime of
    their own (ca.init detects the GPU): train-lib and its failure and
    resume, train-lib-fsdp and its reshard onto 2 workers, and the host
    collective groups' probe, under one watchdog, each checked and logged
    as it ends; no process of the session left after shutdown.  The cells
    run the flagship at TL_LAYERS of its layers.  `ref` holds the train
    and train-data cells' ms from this call.  Returns the workers' kernel
    launches (fwd, dQ, dK/dV)."""
    import shutil

    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch.core import api
    from cluster_anywhere_tpu_torch.models import make_train_step
    from cluster_anywhere_tpu_torch.util import state

    cfg = dataclasses.replace(flagship(), n_layers=TL_LAYERS)
    n = TRAIN_STEPS + 1  # the train-data cell's rows: 88 x 1025
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (TRAIN_B * n, TRAIN_T + 1))
    batch = np.random.default_rng(0).integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_T + 1))
    # what the worker's step 1 is held to: the one-device step here on the
    # first batch the Data shard gives it (the rows' first TRAIN_B)
    step, init_state = make_train_step(cfg)
    model, opt = init_state(0)
    ref = dict(ref, step1_loss=step(model, opt, {"ids": torch.from_numpy(ids[:TRAIN_B]).cuda()})[2].item())
    del step, model, opt
    storage = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "train_lib")
    shutil.rmtree(storage, ignore_errors=True)
    os.makedirs(storage)
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    info = ca.init(num_cpus=6)
    try:
        check(info["resources"].get("GPU") == 1.0,
              f"the runtime detected {info['resources'].get('GPU')} GPUs, want 1")
        with watchdog(TL_DEADLINE_S, "the Train library phase"):
            zero_launch_counts(attn)
            launches = tl_report_single(tl_single_cells(cfg, ids, None, True, storage), cfg, ref,
                                        launch_counts(attn))
            fsdp = tl_report_fsdp(tl_fsdp_cells(cfg, batch, None, True, storage))
            launches = tuple(a + b for a, b in zip(launches, fsdp))
            driver = launch_counts(attn)
            host_probe_report(*host_group_probe("cuda"))
        pids = [w["pid"] for w in state.list_workers()] + [api._head_proc.pid]
        log(f"[train-lib] {heartbeat_report(api._session_dir)}")
    except BaseException:
        print_session_errors(api._session_dir)
        raise
    finally:
        ca.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    wait_gone(pids, "the Train session")
    log(f"[train-lib] phase 8 in {time.perf_counter() - t_phase:.1f} s on "
        f"{gpu_clocks('name,power.limit')}; workers' launches (fwd, dQ, dK/dV) {launches}, the "
        f"driver's {driver}")
    check(driver == (0, 0, 0), f"the driver launched kernels during the Train fits: {driver}")
    return launches


def print_session_errors(session_dir, lines=40):
    """To stderr: the causes of the workers the head declared dead, and
    each session log's lines from its first traceback or error on (what a
    worker that died said before it went)."""
    import glob

    for wid, cause in worker_deaths(session_dir):
        print(f"--- the head declared worker {wid} dead: {cause}", file=sys.stderr)

    for path in sorted(glob.glob(os.path.join(session_dir or "", "*.log"))):
        with open(path, errors="replace") as f:
            text = f.read().splitlines()
        first = next((i for i, ln in enumerate(text) if "Traceback" in ln or "Error" in ln), None)
        if first is not None:
            print(f"--- {path} ---", *text[max(0, first - 2):first + lines], sep="\n",
                  file=sys.stderr)


def host_probe_report(ms, sent, err, bound):
    log(f"[host-groups] 4 actors (0.25 GPU each) in one 'host' collective group, a CUDA tensor "
        f"of 1024 x 1024 fp32 each (copied to the host by the group, results back on the card): "
        f"median ms of {HOST_PROBE_REPS} " + ", ".join(
            f"{k} {ms[k]:.3f} ms / {sent[k]} B sent a rank" for k in ms)
        + f"; f32 results equal to the driver's (the ring's adds replayed) bit for bit; int8 "
        f"allreduce equal to the driver's replay, and in the block nearest its bound |int8 - "
        f"exact| {err:.6g} against {bound:.6g} (max|block| / 254 for each of its 4 quantizations, "
        f"plus the adds' rounding)")


def tl_report_single(one, cfg, ref, driver):
    """Checks and logs of train-lib and its resume; returns the workers'
    launches summed over both fits."""
    first, again = one["first"], one["again"]
    steps = tl_steps(first.metrics_history)
    losses = [m["loss"] for m in steps]
    check([m["step"] for m in steps] == list(range(1, TL_STEPS + 1)),
          f"[train-lib] steps reported {[m['step'] for m in steps]}")
    rel1 = abs(losses[0] - ref["step1_loss"]) / abs(ref["step1_loss"])
    step_ms = float(np.median([m["step_ms"] for m in steps[1:]]))
    saves = [m for m in first.metrics_history if "save_ms" in m]
    copies = [m["report_ms"] for m in first.metrics_history if "report_ms" in m]
    startup = steps[0]["t_start"] - one["first_t0"]
    kept = sorted(int(c.load_pytree()["opt"]["count"]) for c, _ in first.best_checkpoints)
    log(f"[train-lib] TorchTrainer, 1 GPU worker, the flagship at {cfg.n_layers} layers from seed 0, "
        f"cad.from_numpy(ids "
        f"{TRAIN_B * (TRAIN_STEPS + 1)} x {TRAIN_T + 1}) through get_dataset_shard(...)."
        f"iter_torch_batches(batch_size={TRAIN_B}): step {step_ms:.2f} ms (median of steps 2-"
        f"{TL_STEPS}, worker's clock) against the train cell's {ref['train_ms']:.2f} and the "
        f"train-data cell's {ref['train_data_ms']:.2f} at 8 layers in this call; fit "
        f"{one['first_s']:.2f} s, "
        f"the worker's loop started {startup:.2f} s after fit() began and built the model in "
        f"{steps[0]['build_s']:.2f} s; save_pytree of params and AdamW state "
        + ", ".join(f"{m['save_ms']:.0f} ms for {m['save_bytes'] / 1e9:.3f} GB" for m in saves)
        + f", report's copy into the trial dir {', '.join(f'{x:.0f}' for x in copies)} ms; "
        f"kept checkpoints (num_to_keep=2) of steps {kept}")
    log(f"[train-lib] step 1's loss {losses[0]:.6f} vs the one-device step's on the same batch "
        f"{ref['step1_loss']:.6f} "
        f"(relative {rel1:.3g}, limit {TL_TOL['step1_rel']:g}); loss over {TL_STEPS} steps "
        f"{' '.join(f'{x:.4f}' for x in losses)}; launches a step in the worker "
        f"{sorted({tuple(m['launches']) for m in steps})}, in the driver {driver}")
    check(rel1 <= TL_TOL["step1_rel"], "[train-lib] step 1's loss is off the one-device step's")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"[train-lib] loss did not fall: {losses}")
    check(all(tuple(m["launches"]) == (cfg.n_layers,) * 3 for m in steps),
          f"[train-lib] a step did not launch each kernel {cfg.n_layers} times in the worker")
    check(kept == [TL_CKPT_EVERY, TL_STEPS], f"[train-lib] kept checkpoints of steps {kept}")
    # the resume
    a0, a1 = tl_steps(again.metrics_history, 0), tl_steps(again.metrics_history, 1)
    check([m["step"] for m in a0] == list(range(1, TL_FAIL_AFTER + 1))
          and [m["step"] for m in a1] == list(range(TL_CKPT_EVERY + 1, TL_STEPS + 1)),
          f"[train-lib] the failing fit reported steps {[m['step'] for m in a0]} then "
          f"{[m['step'] for m in a1]}")
    rel = [abs(m["loss"] - losses[m["step"] - 1]) / abs(losses[m["step"] - 1]) for m in a1]
    rel0 = [abs(m["loss"] - losses[m["step"] - 1]) / abs(losses[m["step"] - 1]) for m in a0]
    restart = a1[0]["t_start"] - one["t_fail"]
    done = [m for m in again.metrics_history if m.get("done")]
    tree = again.checkpoint.load_pytree()
    from cluster_anywhere_tpu_torch.train.checkpoint import tree_flatten
    import hashlib

    h = hashlib.sha256()
    for leaf in tree_flatten(tree["params"])[0]:
        h.update(leaf.tobytes())
    log(f"[train-lib] failure and resume: the loop raised after step {TL_FAIL_AFTER}, the "
        f"controller restarted it from step {TL_CKPT_EVERY}'s checkpoint: worker restart "
        f"{restart:.2f} s (failure to the new loop's start) + checkpoint load "
        f"{a1[0]['load_s']:.2f} s; fit {one['again_s']:.2f} s; steps {TL_CKPT_EVERY + 1}-{TL_STEPS} "
        f"against the first fit's: largest relative difference {max(rel):.3g} (limit "
        f"{TL_TOL['resume_rel']:g}), steps 1-{TL_FAIL_AFTER} before the failure {max(rel0):.3g}; "
        f"Result.checkpoint (step {int(tree['opt']['count'])}) params sha256 {h.hexdigest()[:16]} "
        f"vs the worker's {done[-1]['params_sha256'][:16] if done else None}")
    check(again.error is None and max(rel) <= TL_TOL["resume_rel"],
          "[train-lib] the resumed steps are off the first fit's")
    check(bool(done) and h.hexdigest() == done[-1]["params_sha256"],
          "[train-lib] Result.checkpoint's params are not the worker's final params")
    return tuple(map(sum, zip(*(m["launches"] for m in steps + a0 + a1))))


def tl_report_fsdp(fsdp):
    """Checks and logs of train-lib-fsdp; returns the workers' launches."""
    four, two = tl_steps(fsdp["four"].metrics_history), tl_steps(fsdp["two"].metrics_history)
    check([m["step"] for m in four] == list(range(1, TL_FSDP_STEPS + 1))
          and [m["step"] for m in two] == [TL_FSDP_CKPT + 1],
          f"[train-lib-fsdp] steps {[m['step'] for m in four]}, resumed {[m['step'] for m in two]}")
    losses = [m["loss"] for m in four]
    want, got = four[TL_FSDP_CKPT]["loss"], two[0]["loss"]
    rel = abs(got - want) / abs(want)
    launches = tuple(map(sum, zip(*(m["launches"] for m in four + two))))
    save = [m["save_ms"] for m in four if "save_ms" in m]
    log(f"[train-lib-fsdp] TorchTrainer, 4 workers at 0.25 GPU sharing the card, "
        f"TorchConfig(backend='gloo'), fsdp2 x tp2 at flagship width and {TL_LAYERS} layers: step "
        f"{float(np.median([m['step_ms'] for m in four[1:]])):.1f} ms (median of steps 2-"
        f"{TL_FSDP_STEPS}, rank 0's clock; 4 ranks on one card: not a scaling number); "
        f"save_pytree_sharded after step {TL_FSDP_CKPT} {save[0]:.0f} ms; fit "
        f"{fsdp['four_s']:.2f} s; loss {' '.join(f'{x:.4f}' for x in losses)}; then 2 workers at 0.5 "
        f"GPU on fsdp2 resumed through load_pytree_sharded (fit {fsdp['two_s']:.2f} s): step "
        f"{TL_FSDP_CKPT + 1}'s loss {got:.6f} vs {want:.6f} (relative {rel:.3g}, limit "
        f"{TL_TOL['reshard_rel']:g}), step {two[0]['step_ms']:.1f} ms; launches in the workers, all "
        f"ranks (fwd, dQ, dK/dV) {launches}")
    check(rel <= TL_TOL["reshard_rel"], "[train-lib-fsdp] the resharded step is off the 4-worker run's")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0], f"[train-lib-fsdp] loss did not fall: {losses}")
    check(all(x > 0 for x in launches), f"[train-lib-fsdp] a kernel did not launch in the workers: {launches}")
    return launches


# ----------------------------------------------------------------- phase 9
# The device plane, on a session of the port's runtime of its own: the
# generate cell's prompts prefilled in one GPU actor, whose KV cache a
# second GPU actor decodes from, handed over as a DeviceRef (device-ref)
# and over a compiled DAG's tensor-transport edge (dag-transport); then one
# SSE wave of the serve-http cell on the streaming-RPC transport
# (serve_compiled_dag=False) beside phase 4b's compiled stream.

DP_DEADLINE_S = 600  # the whole phase, under one watchdog
DP_REPS = 5  # timed hops and executes, each a median over these
DP_SEEDS = (0, 1, 2)  # the prompt sets of dag-transport; seed 0 is the generate cell's
STRICT = "CA_DEVICE_TRANSPORT_STRICT"
# what the Prefiller may hold, after every ref is dropped, above its level
# after the first prefill (which held one result): its results are released
DP_HELD_SLACK = 80_000_000


def generate_prompts(torch, cfg, seed, device):
    """The generate cell's prompts (seed 0), or another set of the same
    lengths: [B, T] ids left-padded to T, and the real lengths."""
    lens = prompt_lens()
    ids = np.random.default_rng(seed).integers(3, cfg.vocab_size, (B, T))
    for i, n in enumerate(lens):
        ids[i, : T - n] = 0
    return torch.from_numpy(ids).to(device), torch.from_numpy(lens).to(device)


def device_plane_actors():
    """Prefiller and Decoder: actors at half of the card, each holding the
    model from init_params(cfg, 0), with the transport in strict mode
    (defined in a function: they travel to the workers by value)."""
    import cluster_anywhere_tpu_torch as ca

    class Half:
        def __init__(self, cfg, device):
            import os

            import torch

            from cluster_anywhere_tpu_torch.models.transformer import init_params

            os.environ[STRICT] = "1"
            self.cfg, self.device = cfg, torch.device(device)
            self.model = init_params(cfg, 0, device=self.device)

        def probe(self, reset=False):
            """This process: pid, the forward's launches, the card's
            allocated bytes, the device objects it holds, the transport's
            and the channels' counters."""
            import os

            import torch

            from cluster_anywhere_tpu_torch.channel import device_transport
            from cluster_anywhere_tpu_torch.channel.shm_channel import CHANNEL_STATS
            from cluster_anywhere_tpu_torch.core.worker import global_worker
            from cluster_anywhere_tpu_torch.ops.attention import flash_attention

            cuda = self.device.type == "cuda"
            out = {"pid": os.getpid(), "launches": flash_attention.launches,
                   "allocated": torch.cuda.memory_allocated(self.device) if cuda else 0,
                   "gpu": torch.cuda.get_device_name(self.device) if cuda else "cpu",
                   "device_objects": len(global_worker().device_objects),
                   "transport": device_transport.stats(), "channel": dict(CHANNEL_STATS),
                   "strict": os.environ.get(STRICT)}
            if reset:
                flash_attention.launches = 0
                device_transport.reset_stats()
            return out

    @ca.remote
    class Prefiller(Half):
        def prefill(self, inp):
            """{"ids", "lens"} -> the prefill's last logits [B, V] fp32 and
            its cache {"k","v"} [L, B, T + new, KV, D], on the card, with
            the pad and the prompt length decode_one needs."""
            import torch

            from cluster_anywhere_tpu_torch.models.generate import prefill

            ids = torch.as_tensor(inp["ids"], device=self.device).long()
            pad = ids.shape[1] - torch.as_tensor(inp["lens"], device=self.device).long()
            with torch.no_grad():
                logits, cache = prefill(self.model, ids, self.cfg, ids.shape[1] + inp["new"],
                                        pad=pad)
            self.last = {"logits": logits, "cache": cache}
            return {"logits": logits, "cache": cache, "pad": pad, "t_prompt": ids.shape[1]}

        def held(self, out):
            """Whether `out`, passed back in, is the stored value itself."""
            return [out["cache"] is self.last["cache"],
                    out["cache"]["k"].data_ptr() == self.last["cache"]["k"].data_ptr(),
                    out["cache"]["k"].data_ptr()]

        def digest(self, out):
            import torch

            return cache_digest(torch, out["cache"])

    @ca.remote
    class Decoder(Half):
        def land(self, out):
            """Where the argument landed, after its copies finished."""
            import torch

            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            return [str(out["cache"]["k"].device), str(out["logits"].device),
                    type(out["cache"]["k"]).__name__]

        def decode(self, out):
            """generate's decode loop on the landed prefill: greedy tokens
            [B, 1 + T_max - 1 - t_prompt] (numpy) and where the cache landed."""
            import torch

            from cluster_anywhere_tpu_torch.models.generate import decode_one

            cache, pad = out["cache"], out["pad"]
            token = out["logits"].argmax(dim=-1).to(torch.int32)
            toks = [token]
            with torch.no_grad():
                for pos in range(out["t_prompt"], cache["k"].shape[2] - 1):
                    logits, cache = decode_one(self.model, cache, token, pos, self.cfg, pad)
                    token = logits.argmax(dim=-1).to(torch.int32)
                    toks.append(token)
            return {"tokens": torch.stack(toks, dim=1).cpu().numpy(),
                    "landed": [str(cache["k"].device), str(out["logits"].device)]}

    return Prefiller, Decoder


def near_tie_rows(torch, model, cfg, ids, lens, want, got, what, tag="dag-transport"):
    """Rows of got against want (token ids [B, N]): a differing row must
    be a near-tie where it first differs (both tokens the top two of the
    row's logits there, at most NEAR_TIE_GAP apart; one plain prefill of
    the row's real prompt and want's tokens before it).  Returns the count
    of differing rows."""
    from cluster_anywhere_tpu_torch.models.generate import prefill

    differing = 0
    for i in range(len(want)):
        w, g = [int(x) for x in want[i]], [int(x) for x in got[i]]
        if w == g:
            continue
        differing += 1
        k = next(j for j in range(len(w)) if w[j] != g[j])
        row = torch.cat([ids[i, T - int(lens[i]):], torch.tensor(w[:k], device=ids.device)])[None]
        with torch.no_grad():
            logits, _ = prefill(model, row.long(), cfg, row.shape[1] + 1)
        top = logits[0].float().topk(2)
        pair, gap = top.indices.tolist(), (top.values[0] - top.values[1]).item()
        tie = w[k] in pair and g[k] in pair and gap <= NEAR_TIE_GAP
        log(f"[{tag}] {what} row {i} differs at token {k} ({w[k]} vs {g[k]}): top two {pair}, "
            f"logit gap {gap:.4f}, near-tie {tie}")
        check(tie, f"[{tag}] {what} row {i} differs, and not on a near-tie")
    return differing


def tokens_vs_generate(torch, cfg, device, gen_tokens, tokens, what, tag):
    """Rows of the generate cell's tokens against another run's; a
    differing row must be a near-tie.  Returns the rows that differ."""
    tokens = np.asarray(tokens)
    check(tokens.shape == (B, N_NEW), f"[{tag}] tokens {tokens.shape}")
    if np.array_equal(tokens, gen_tokens):
        return 0
    from cluster_anywhere_tpu_torch.models.transformer import init_params

    model = init_params(cfg, 0, device=device)
    ids, lens = generate_prompts(torch, cfg, 0, device)
    try:
        return near_tie_rows(torch, model, cfg, ids, lens, gen_tokens, tokens, what, tag)
    finally:
        del model


def cache_digest(torch, cache):
    import hashlib

    h = hashlib.sha256()
    for name in ("k", "v"):
        h.update(cache[name].cpu().view(torch.int16).numpy().tobytes())
    return h.hexdigest()


def dp_device_ref(torch, ca, prefiller, decoder, inp, want, nbytes):
    """The device-ref cell: returns its numbers."""
    t0 = time.perf_counter()
    ref = prefiller.prefill.remote(inp)
    check(ca.wait([ref], timeout=300)[0] == [ref], "[device-ref] the prefill did not finish")
    prefill_s = time.perf_counter() - t0
    before_hop = ca.get(prefiller.probe.remote(), timeout=60)
    held = ca.get(prefiller.held.remote(ref), timeout=120)
    check(held[:2] == [True, True], f"[device-ref] the ref passed back to its owner is not the "
          f"stored value itself: {held}")
    out = ca.get(decoder.decode.remote(ref), timeout=300)
    check(out["landed"][0].startswith(str(decoder_device(torch))),
          f"[device-ref] the cache landed in the Decoder on {out['landed']}")
    check(out["tokens"].shape == (B, N_NEW), f"[device-ref] decoded {out['tokens'].shape}")
    got = ca.get(ref, timeout=300)
    digest = ca.get(prefiller.digest.remote(ref), timeout=120)
    check(cache_digest(torch, got["cache"]) == digest,
          "[device-ref] the driver's landed cache is not the actor's bytes")
    check(got["cache"]["k"].device.type == decoder_device(torch).type,
          f"[device-ref] the driver's get landed on {got['cache']['k'].device}")
    del got
    hop, get = [], []
    for _ in range(DP_REPS):  # a fresh ref each time: a fetched value is cached by its getter
        ref = prefiller.prefill.remote(inp)
        ca.wait([ref], timeout=300)
        t0 = time.perf_counter()
        landed = ca.get(decoder.land.remote(ref), timeout=300)
        hop.append(time.perf_counter() - t0)
        ref = prefiller.prefill.remote(inp)
        ca.wait([ref], timeout=300)
        t0 = time.perf_counter()
        v = ca.get(ref, timeout=300)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        get.append(time.perf_counter() - t0)
        del v, ref
    return {"tokens": out["tokens"], "held": held, "prefill_s": prefill_s, "landed": landed,
            "before_hop": before_hop,
            "hop_ms": float(np.median(hop)) * 1e3, "get_ms": float(np.median(get)) * 1e3,
            "hop_gbs": nbytes / float(np.median(hop)) / 1e9,
            "get_gbs": nbytes / float(np.median(get)) / 1e9, "digest": digest[:16]}


def decoder_device(torch):
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def dp_dag_transport(ca, prefiller, decoder, inputs):
    """The dag-transport cell: decode(prefill(inp)) compiled with a
    tensor-transport edge, one execute per prompt set, then DP_REPS timed
    after a warm-up.  Returns each set's tokens and the executes' ms."""
    from cluster_anywhere_tpu_torch.dag import InputNode

    with InputNode() as inp:
        node = decoder.decode.bind(prefiller.prefill.bind(inp).with_tensor_transport())
    dag = node.experimental_compile()
    try:
        outs = [dag.execute(x).get(timeout=300) for x in inputs]
        dag.execute(inputs[0]).get(timeout=300)
        ms = []
        for _ in range(DP_REPS):
            t0 = time.perf_counter()
            dag.execute(inputs[0]).get(timeout=300)
            ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        dag.teardown()
    return outs, ms


def dp_rpc_wave(torch, ca, cfg, server_tokens, device):
    """One SSE wave of the serve-http cell on this session's streaming-RPC
    transport: returns the replica's forward launches and the wave's
    TTFTs and inter-arrival times (s)."""
    from cluster_anywhere_tpu_torch import serve
    from cluster_anywhere_tpu_torch.llm import build_continuous_llm_deployment

    serve.start(port=0)
    url = ca.get(ca.get_actor(serve.PROXY_NAME).ready.remote(), timeout=60) + "/llm"
    app = build_continuous_llm_deployment(server_config(cfg), num_gpus=1, slots=8,
                                          sse_ingress=True,
                                          device=None if device == "cuda" else device)
    app.deployment.func_or_class = counting_ingress()
    handle = serve.run(app, name="llm", route_prefix="/llm", wait_timeout_s=240)
    handle.options(method_name="probe").remote(reset=True).result(timeout_s=60)
    proxy = ca.get_actor(serve.PROXY_NAME)
    before = ca.get(proxy.stream_stats.remote(), timeout=60)
    prompts, gaps = server_prompts(), []
    streams, wall = in_threads(
        lambda i: token_stream(sse_events(url, {"prompt": prompts[i]}), gaps), B)
    after = handle.options(method_name="probe").remote().result(timeout_s=60)
    opened = {k: ca.get(proxy.stream_stats.remote(), timeout=60)[k] - before[k]
              for k in ("dag", "rpc", "fallbacks")}
    check(opened == {"dag": 0, "rpc": B, "fallbacks": 0} and after["handshakes"] == 0,
          f"[serve-rpc] with serve_compiled_dag=False the proxy opened {opened}, the replica "
          f"had {after['handshakes']} handshakes")
    check(all(len(t) == N_NEW for _, t in streams), "[serve-rpc] a stream is short")
    differing = compare_rows(torch, server_config(cfg), prompts, server_tokens,
                             [t for _, t in streams], "SSE (RPC)", [], tag="serve-rpc")
    ttft = [first for first, _ in streams]
    serve.shutdown()
    return after["launches"], {"ttft": ttft, "gaps": gaps, "wall": wall,
                               "equal": B - differing, "opened": opened}


def phase_device_plane(torch, attn, cfg, gen_tokens, server_tokens, compiled_sse,
                       device="cuda"):
    """The device-plane cells on a session of the port's runtime of its own
    (device-ref, dag-transport, the RPC SSE wave), after the device-plane
    dry run on its own session, each checked and logged as it ends.
    gen_tokens: the generate cell's tokens [B, N_NEW]; server_tokens: the
    server cell's; compiled_sse: phase 4b's first SSE wave.  Returns the
    forward's launches in the Prefiller and the RPC wave's replica."""
    import gc

    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch.core import api
    from cluster_anywhere_tpu_torch.entry import dryrun_device_plane
    from cluster_anywhere_tpu_torch.models.generate import generate
    from cluster_anywhere_tpu_torch.models.transformer import init_params
    from cluster_anywhere_tpu_torch.util import state

    t_phase = time.perf_counter()
    card = gpu_clocks("name,power.limit") if device == "cuda" else "cpu"
    df = subprocess.run(["df", "-h", "/dev/shm"], capture_output=True, text=True, timeout=60)
    log(f"[device-plane] df -h /dev/shm: {' | '.join(df.stdout.strip().splitlines())}")
    dryrun_device_plane(device)
    os.environ[STRICT] = "1"
    if device == "cuda":
        torch.cuda.empty_cache()
    info = ca.init(num_cpus=4, serve_compiled_dag=False,
                   **({} if device == "cuda" else {"num_gpus": 1}))
    try:
        check(info["resources"].get("GPU") == 1.0,
              f"the runtime detected {info['resources'].get('GPU')} GPUs, want 1")
        with watchdog(DP_DEADLINE_S, "the device-plane phase"):
            Prefiller, Decoder = device_plane_actors()
            gpu = 0.5 if device == "cuda" else 0
            prefiller = Prefiller.options(num_gpus=gpu).remote(cfg, device)
            decoder = Decoder.options(num_gpus=gpu).remote(cfg, device)
            probes = ca.get([prefiller.probe.remote(True), decoder.probe.remote(True)],
                            timeout=300)
            check(probes[0]["pid"] != probes[1]["pid"] != os.getpid()
                  and all(p["strict"] == "1" for p in probes),
                  f"the actors are not two processes of their own in strict mode: {probes}")
            inputs = []
            for seed in DP_SEEDS:
                ids, lens = generate_prompts(torch, cfg, seed, "cpu")
                inputs.append({"ids": ids.numpy(), "lens": lens.numpy(), "new": N_NEW})
            kv = 2 * cfg.n_layers * B * (T + N_NEW) * cfg.n_kv_heads * cfg.d_head * 2
            nbytes = kv + B * cfg.vocab_size * 4 + B * 8

            # device-ref
            one = dp_device_ref(torch, ca, prefiller, decoder, inputs[0], gen_tokens, nbytes)
            model = init_params(cfg, 0, device=device)
            ids0, lens0 = generate_prompts(torch, cfg, 0, device)
            differing = near_tie_rows(torch, model, cfg, ids0, lens0, gen_tokens, one["tokens"],
                                      "device-ref vs generate", "device-ref")
            log(f"[device-ref] the generate cell's prompts prefilled in the Prefiller "
                f"({probes[0]['gpu']}, pid {probes[0]['pid']}), decoded by the Decoder (pid "
                f"{probes[1]['pid']}): {B - differing} of {B} rows equal to the generate cell's; "
                f"the ref passed back to its owner resolves to the stored object (data_ptr "
                f"{one['held'][2]:#x}); the driver's ca.get lands the cache on "
                f"{decoder_device(torch)} with the actor's bytes (sha256 {one['digest']}...); "
                f"a hop of {nbytes} B (cache {kv}, logits, pad), median of {DP_REPS} fresh refs: "
                f"the Decoder's call taking the ref {one['hop_ms']:.2f} ms "
                f"({one['hop_gbs']:.2f} GB/s, landed on {one['landed'][0]}), the driver's get "
                f"{one['get_ms']:.2f} ms ({one['get_gbs']:.2f} GB/s); on {card}")

            # dag-transport
            ca.get(decoder.probe.remote(True), timeout=60)
            outs, exec_ms = dp_dag_transport(ca, prefiller, decoder, inputs)
            tr = ca.get(decoder.probe.remote(), timeout=60)["transport"]
            pre = ca.get(prefiller.probe.remote(), timeout=60)
            check(tr["leaves_landed"] > 0 and tr["cuda_landings" if device == "cuda"
                                                    else "cpu_landings"] == tr["leaves_landed"]
                  and (device != "cuda" or tr["cpu_landings"] == 0),
                  f"[dag-transport] the Decoder's landings {tr}")
            check(all(o["landed"][0].startswith(device) for o in outs),
                  f"[dag-transport] the cache landed on {[o['landed'] for o in outs]}")
            equal = []
            for seed, o in zip(DP_SEEDS, outs):
                ids, lens = generate_prompts(torch, cfg, seed, device)
                want = gen_tokens if seed == 0 else generate(
                    model, ids, cfg=cfg, max_new_tokens=N_NEW, prompt_lens=lens).cpu().numpy()
                equal.append(B - near_tie_rows(torch, model, cfg, ids, lens, want, o["tokens"],
                                               f"prompt set {seed}"))
            log(f"[dag-transport] decode.bind(prefill.bind(inp).with_tensor_transport()) "
                f"compiled, strict: prompt sets {list(DP_SEEDS)} (seed 0 the generate cell's, the "
                f"others against generate in the driver): {equal} of {B} rows equal; per-execute "
                f"{np.median(exec_ms):.2f} ms (median of {DP_REPS} after a warm-up: "
                f"{' '.join(f'{x:.1f}' for x in exec_ms)}) against device-ref's hop "
                f"{one['hop_ms']:.2f} ms and its first (cold) prefill call "
                f"{one['prefill_s'] * 1e3:.2f} ms; "
                f"the Decoder's landings {tr}; the Prefiller's channel counters "
                f"{pre['channel']}; on {card}")
            del model
            gc.collect()
            if device == "cuda":
                torch.cuda.empty_cache()

            # the producer after the driver dropped every ref
            time.sleep(1.0)
            held = ca.get(prefiller.probe.remote(), timeout=60)
            launches = held["launches"]
            log(f"[device-ref] the Prefiller's memory_allocated: {probes[0]['allocated']} B "
                f"with the weights alone, {one['before_hop']['allocated']} B after the first "
                f"prefill, before the hop ({one['before_hop']['device_objects']} device objects "
                f"held), {held['allocated']} B with {held['device_objects']} device objects held "
                f"after the driver dropped every ref (the owner releases what the actor holds; "
                f"bound: {DP_HELD_SLACK} B above the first prefill's level); its flash_fwd "
                f"launches {launches}")
            check(launches > 0, f"the Prefiller never launched flash_fwd: {held}")
            check(held["device_objects"] == 0
                  and held["allocated"] <= one["before_hop"]["allocated"] + DP_HELD_SLACK,
                  f"[device-ref] the Prefiller holds {held['device_objects']} device objects and "
                  f"{held['allocated']} B after every ref was dropped, against "
                  f"{one['before_hop']['allocated']} B after its first prefill")
            for a in (prefiller, decoder):
                ca.kill(a)

            # the RPC stream
            rpc_launches, rpc = dp_rpc_wave(torch, ca, cfg, server_tokens, device)
            log(f"[serve-rpc] one SSE wave of 8 on streaming RPC (serve_compiled_dag=False): "
                f"TTFT p50 {np.median(rpc['ttft']) * 1e3:.1f} ms, max "
                f"{max(rpc['ttft']) * 1e3:.1f} ms, token inter-arrival p50 "
                f"{np.median(rpc['gaps']) * 1e3:.2f} ms; {rpc['equal']} of {B} streams equal to "
                f"the in-process server's; the proxy opened {rpc['opened']}; the replica's "
                f"flash_fwd launches {rpc_launches}; phase 4b's first wave on the compiled "
                f"stream (same call): TTFT p50 {np.median(compiled_sse['ttft']) * 1e3:.1f} ms, "
                f"max {max(compiled_sse['ttft']) * 1e3:.1f} ms, inter-arrival p50 "
                f"{np.median(compiled_sse['gaps']) * 1e3:.2f} ms; on {card}")
            check(rpc_launches >= cfg.n_layers,
                  f"[serve-rpc] the replica launched flash_fwd {rpc_launches} times")
        pids = [w["pid"] for w in state.list_workers()] + [api._head_proc.pid]
        log(f"[device-plane] {heartbeat_report(api._session_dir)}")
    except BaseException:
        print_session_errors(api._session_dir)
        raise
    finally:
        os.environ.pop(STRICT, None)
        ca.shutdown()
    wait_gone(pids, "the device-plane session")
    log(f"[device-plane] phase 9 in {time.perf_counter() - t_phase:.1f} s; none of {len(pids)} "
        f"processes of its session left")
    return launches + rpc_launches


RL_DEADLINE_S = 600  # the whole phase, under one watchdog
RL_UPDATES = 3  # each learner's updates on the card and on the CPU
RL_TOL = {"loss_rel": 1e-5, "param_rel_l2": 1e-4}
RL_ITERS = 12
RL_PPO = dict(lr=3e-3, rollout_length=128, epochs=6, seed=3)  # tests/test_rl.py:61-80
RL_RUNNERS, RL_ENVS = 2, 4
RL_DREAMER = dict(obs_dim=4, num_actions=2, ac_lr=3e-4, entropy=1e-2, horizon=15)  # :615-617
RL_DREAMER_RUN = dict(episodes=22, updates_per_episode=10, seed=0)  # bounded to fit the phase


def rl_cases():
    """Each learner of the rl-learners cell: name -> (make(device), the
    batches of its RL_UPDATES updates, their noise or None), at the
    widths AlgorithmConfig and DreamerConfig give and the batch sizes
    their algorithms feed them (rl-ppo's PPO batch: 2 runners x 4 envs x
    128 steps)."""
    from cluster_anywhere_tpu_torch import rl
    from cluster_anywhere_tpu_torch.rl.learner import SACLearner, TD3Learner
    from cluster_anywhere_tpu_torch.rl.module import (
        DeterministicPolicyModule, SquashedGaussianModule, TwinQModule)

    rng = np.random.default_rng(0)
    f32 = np.float32

    def flat(n=1024, d=4):
        return {"obs": rng.normal(size=(n, d)).astype(f32), "actions": rng.integers(0, 2, n).astype(np.int32),
                "logp_old": (np.log(0.5) + rng.normal(0, 0.2, n)).astype(f32),
                "advantages": rng.normal(size=n).astype(f32), "returns": rng.normal(size=n).astype(f32)}

    def seq(T=128, N=8, d=3, h=64):
        return {"obs": rng.normal(size=(T, N, d)).astype(f32),
                "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
                "logp_old": (np.log(0.5) + rng.normal(0, 0.2, (T, N))).astype(f32),
                "dones": (rng.random((T, N)) < 0.1).astype(f32),
                "advantages": rng.normal(size=(T, N)).astype(f32),
                "returns": rng.normal(size=(T, N)).astype(f32), "state0": rng.normal(size=(N, h)).astype(f32)}

    def trans(n=64, d=4, act_dim=0, per=False):
        b = {"obs": rng.normal(size=(n, d)).astype(f32),
             "actions": rng.uniform(-2, 2, (n, act_dim)).astype(f32) if act_dim
             else rng.integers(0, 2, n).astype(np.int32),
             "rewards": rng.normal(size=n).astype(f32), "dones": (rng.random(n) < 0.1).astype(f32),
             "next_obs": rng.normal(size=(n, d)).astype(f32)}
        if per:
            b["weights"] = rng.uniform(0.2, 1.0, n).astype(f32)
            b["indices"] = np.arange(n, dtype=np.int64)
        return b

    def rollout(T=64, N=4, d=4):
        return {"obs": rng.normal(size=(T, N, d)).astype(f32),
                "actions": rng.integers(0, 2, (T, N)).astype(np.int32),
                "rewards": rng.normal(size=(T, N)).astype(f32), "dones": rng.random((T, N)) < 0.05,
                "logp": (np.log(0.5) + rng.normal(0, 0.2, (T, N))).astype(f32),
                "next_obs": rng.normal(size=(N, d)).astype(f32)}

    def dreamer_batch(c):
        B, L = c.batch_size, c.seq_len
        first = (rng.random((B, L)) < 0.05).astype(f32)
        first[:, 0] = 1.0
        return {"obs": rng.normal(size=(B, L, c.obs_dim)).astype(f32),
                "actions": rng.integers(0, c.num_actions, (B, L)).astype(np.int32),
                "rewards": rng.normal(size=(B, L)).astype(f32),
                "cont": (rng.random((B, L)) > 0.05).astype(f32), "is_first": first}

    def dreamer_noise(c):
        n = c.batch_size * c.seq_len
        return {"wm": rng.gumbel(size=(c.seq_len, c.batch_size, c.groups, c.classes)).astype(f32),
                "act": rng.gumbel(size=(c.horizon, n, c.num_actions)).astype(f32),
                "lat": rng.gumbel(size=(c.horizon, n, c.groups, c.classes)).astype(f32)}

    def many(fn):
        return [fn() for _ in range(RL_UPDATES)]

    dc = rl.DreamerConfig()
    sac_noise = many(lambda: (rng.normal(size=(64, 1)).astype(f32), rng.normal(size=(64, 1)).astype(f32)))
    return {
        "PPO": (lambda d: rl.PPOLearner(rl.DiscretePolicyModule(4, 2), lr=3e-3, epochs=6, seed=3,
                                        device=d), many(flat), None),
        "RecurrentPPO": (lambda d: rl.RecurrentPPOLearner(rl.RecurrentPolicyModule(3, 2, 64), seed=3,
                                                          device=d), many(seq), None),
        "DQN-PER": (lambda d: rl.DQNLearner(rl.QModule(4, 2), target_update_freq=2, seed=3, device=d),
                    many(lambda: trans(per=True)), None),
        "IMPALA": (lambda d: rl.IMPALALearner(rl.DiscretePolicyModule(4, 2), seed=3, device=d),
                   many(rollout), None),
        "APPO": (lambda d: rl.IMPALALearner(rl.DiscretePolicyModule(4, 2), surrogate_clip=0.2, seed=3,
                                            device=d), many(rollout), None),
        "SAC": (lambda d: SACLearner(SquashedGaussianModule(3, 1, 2.0), TwinQModule(3, 1), seed=3,
                                     device=d), many(lambda: trans(d=3, act_dim=1)), sac_noise),
        "TD3": (lambda d: TD3Learner(DeterministicPolicyModule(3, 1, 2.0), TwinQModule(3, 1), seed=3,
                                     device=d), many(lambda: trans(d=3, act_dim=1)),
                many(lambda: rng.normal(size=(64, 1)).astype(f32))),
        "BC": (lambda d: rl.BCLearner(rl.DiscretePolicyModule(4, 2), seed=3, device=d),
               many(lambda: flat(256)), None),
        "CQL": (lambda d: rl.CQLLearner(rl.QModule(4, 2), target_update_freq=2, seed=3, device=d),
                many(lambda: trans(256)), None),
        "MARWIL": (lambda d: rl.MARWILLearner(rl.DiscretePolicyModule(4, 2), seed=3, device=d),
                   many(lambda: flat(256)), None),
        "DreamerV3": (lambda d: rl.DreamerV3Learner(dc, seed=3, device=d),
                      many(lambda: dreamer_batch(dc)), many(lambda: dreamer_noise(dc))),
    }


def rl_tree(learner):
    """A learner's whole state as host arrays by path: its weights and
    target nets (Dreamer: world model, actor-critic, target critic)."""
    from cluster_anywhere_tpu_torch.llm._params_io import _flatten
    from cluster_anywhere_tpu_torch.rl.module import to_numpy

    if hasattr(learner, "wm"):
        tree = {"wm": learner.wm.param_tree(), "ac": learner.ac.param_tree(),
                "target": learner.target_critic.tree()}
    else:
        tree = {"weights": learner.param_tree()}
        for name in ("target", "target_policy", "target_q"):
            if hasattr(learner, name):
                tree[name] = getattr(learner, name).param_tree()
    return _flatten(to_numpy(tree))


def rl_sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def rl_learner_pair(torch, make, batches, noises, device):
    """The same learner on the card (device) and on the CPU, RL_UPDATES
    updates each on the same batches and noise: {"cpu", "card"} -> the
    trees before and after, the stats and the ms of each update."""
    out = {}
    for key, dev in (("cpu", "cpu"), ("card", device)):
        learner = make(dev)
        out[key] = {"start": rl_tree(learner), "stats": [], "ms": []}
        for i, b in enumerate(batches):
            rl_sync(torch)
            t0 = time.perf_counter()
            stats = learner.update(b) if noises is None else learner.update(b, noises[i])
            rl_sync(torch)
            out[key]["ms"].append((time.perf_counter() - t0) * 1e3)
            out[key]["stats"].append(stats)
        out[key]["end"] = rl_tree(learner)
    return out


def rl_errors(pair):
    """(max loss error relative to max(|a|, |b|, 1) over every stat of every
    update, max relative L2 over every leaf after the updates)."""
    loss = 0.0
    for sc, sg in zip(pair["cpu"]["stats"], pair["card"]["stats"]):
        check(sorted(sc) == sorted(sg), f"stats {sorted(sc)} on the CPU, {sorted(sg)} on the card")
        for k in sc:
            a, b = np.asarray(sc[k], np.float64), np.asarray(sg[k], np.float64)
            loss = max(loss, float(np.max(np.abs(a - b) / np.maximum(np.maximum(np.abs(a), np.abs(b)), 1.0))))
    param = 0.0
    end_c, end_g = pair["cpu"]["end"], pair["card"]["end"]
    for k in end_c:
        a, b = end_c[k].astype(np.float64), end_g[k].astype(np.float64)
        param = max(param, float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-12)))
    return loss, param


def rl_learners_cell(torch, card, device):
    """rl-learners: every learner's RL_UPDATES updates on the card held to
    the same updates on the CPU.  Returns the card's ms per update by
    learner."""
    rows = {}
    for name, (make, batches, noises) in rl_cases().items():
        pair = rl_learner_pair(torch, make, batches, noises, device)
        start_c, start_g = pair["cpu"]["start"], pair["card"]["start"]
        check(all(np.array_equal(start_c[k], start_g[k]) for k in start_c),
              f"[rl-learners] {name}: the card's learner did not start from the CPU's params")
        loss, param = rl_errors(pair)
        check(loss <= RL_TOL["loss_rel"] and param <= RL_TOL["param_rel_l2"],
              f"[rl-learners] {name}: the card against the CPU, "
              f"losses {loss:.3e} relative (bound {RL_TOL['loss_rel']}), params {param:.3e} "
              f"relative L2 (bound {RL_TOL['param_rel_l2']})")
        ms_c, ms_g = pair["cpu"]["ms"], pair["card"]["ms"]
        rows[name] = float(np.median(ms_g))
        log(f"[rl-learners] {name}: {RL_UPDATES} updates on the card against the CPU from the same "
            f"params, batches and noise: losses within {loss:.3e} relative, params within "
            f"{param:.3e} relative L2; ms an update on the card "
            f"{' '.join(f'{x:.2f}' for x in ms_g)} (the first cold), on the CPU "
            f"{' '.join(f'{x:.2f}' for x in ms_c)}; {card}")
    return rows


def probe_runner_class():
    """EnvRunner with a probe of its process (defined in a function: it
    travels to the runner actors by value)."""
    from cluster_anywhere_tpu_torch.rl.env_runner import EnvRunner

    class ProbedRunner(EnvRunner):
        def probe(self):
            import os

            import torch

            from cluster_anywhere_tpu_torch.channel import device_transport
            from cluster_anywhere_tpu_torch.core.worker import global_worker

            return {"pid": os.getpid(), "cuda": torch.cuda.is_available(),
                    "transport": device_transport.stats(),
                    "device_objects": len(global_worker().device_objects),
                    "weights_on": str(next(self.module.parameters()).device)}

    return ProbedRunner


def rl_leaf_count(rollouts):
    return sum(1 for ro in rollouts for k, v in ro.items()
               if k != "metrics" and isinstance(v, np.ndarray) and v.dtype.kind in "biufc")


def rl_ppo_cell(torch, ca, rl, compiled_dag, tag, device):
    """rl-ppo (RPC) or rl-ppo-dag: RL_ITERS iterations of tests/test_rl.py's
    PPO with the learner on the card and the runners as CPU actors, one
    more under torch.profiler.  Returns its numbers."""
    from cluster_anywhere_tpu_torch.channel import device_transport
    from cluster_anywhere_tpu_torch.core.worker import global_worker

    held_before = len(global_worker().device_objects)
    device_transport.reset_stats()
    algo = (rl.AlgorithmConfig("PPO").environment("CartPole-v1")
            .env_runners(RL_RUNNERS, num_envs_per_runner=RL_ENVS)
            .training(**RL_PPO, compiled_dag=compiled_dag,
                      device=None if device == "cuda" else device).build())
    try:
        check(next(algo.learner.module.parameters()).device.type == device,
              f"[{tag}] the learner is not on {device}")
        sample_ms, update_ms, first, leaves = [], [], [], [0]
        inner_sample, inner_update = algo._sample, algo.learner.update

        def sample(use_dag):
            t0 = time.perf_counter()
            out = inner_sample(use_dag)
            sample_ms.append((time.perf_counter() - t0) * 1e3)
            if not first:
                first.append([{k: v if k == "metrics" else np.array(v) for k, v in ro.items()}
                              for ro in out])
            leaves[0] += rl_leaf_count(out)
            return out

        def update(batch):
            rl_sync(torch)
            t0 = time.perf_counter()
            out = inner_update(batch)
            rl_sync(torch)
            update_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        algo._sample, algo.learner.update = sample, update
        first_eval = algo.evaluate(3)
        iter_ms, returns, steps = [], [], 0
        for _ in range(RL_ITERS):
            t0 = time.perf_counter()
            r = algo.train()
            iter_ms.append((time.perf_counter() - t0) * 1e3)
            steps += r["env_steps_this_iter"]
            returns.append(r.get("episode_return_mean"))
        final_eval = algo.evaluate(3)
        busy = rl_device_busy(torch, algo.train)
        probes = ca.get([r.probe.remote() for r in algo.runners], timeout=120)
        transport = device_transport.stats()
    finally:
        algo.stop()
    check(final_eval > max(2 * first_eval, 80.0),
          f"[{tag}] PPO did not learn: evaluation {first_eval} before, {final_eval} after "
          f"{RL_ITERS} iterations; returns {returns}")
    # the learner's CUDA weights land on the runners' CPU (on a host
    # rehearsal they are CPU tensors and pickle as they are)
    check(all(not p["cuda"] and p["weights_on"] == "cpu" and p["device_objects"] == 0
              and p["transport"]["cuda_landings"] == 0
              and (device != "cuda" or p["transport"]["cpu_landings"] > 0) for p in probes),
          f"[{tag}] the runners: {probes}")
    check(len(global_worker().device_objects) == held_before,
          f"[{tag}] the driver holds {len(global_worker().device_objects) - held_before} more "
          f"device objects")
    return {"first_eval": first_eval, "final_eval": final_eval, "returns": returns,
            "iter_ms": iter_ms, "sample_ms": sample_ms, "update_ms": update_ms,
            "steps_s": steps / (sum(iter_ms) / 1e3), "busy": busy, "first": first[0],
            "leaves": leaves[0], "transport": transport, "probes": probes}


def rl_device_busy(torch, fn):
    """(device busy ms, wall ms) of one fn() under torch.profiler; None
    where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        rl_sync(torch)
        t0 = time.perf_counter()
        fn()
        rl_sync(torch)
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False) and e.self_device_time_total > 0]
    if not kernels:
        return None
    return sum(e.self_device_time_total for e in kernels) / 1e3, wall


def rl_ppo_report(tag, got, card):
    busy = got["busy"]
    share = ("not measured (the profiler recorded no device time)" if busy is None else
             f"{busy[0]:.2f} device-busy ms of a {busy[1]:.2f}-ms profiled iteration "
             f"({busy[0] / busy[1] * 100:.1f}%)")
    med_iter, med_upd = np.median(got["iter_ms"]), np.median(got["update_ms"])
    log(f"[{tag}] PPO on CartPole, {RL_RUNNERS} runners x {RL_ENVS} envs, rollout "
        f"{RL_PPO['rollout_length']}, {RL_PPO['epochs']} epochs, lr {RL_PPO['lr']}, seed "
        f"{RL_PPO['seed']}, the learner on the card: evaluation {got['first_eval']:.1f} before, "
        f"{got['final_eval']:.1f} after {RL_ITERS} iterations (returns "
        f"{[None if r is None else round(r, 1) for r in got['returns']]}); iteration median "
        f"{med_iter:.2f} ms (first {got['iter_ms'][0]:.2f}); the learner's update median "
        f"{med_upd:.2f} ms ({med_upd / med_iter * 100:.1f}% of an iteration), sampling median "
        f"{np.median(got['sample_ms']):.2f} ms; {got['steps_s']:.0f} env steps/s; the device busy: "
        f"{share}; the runners (pids {[p['pid'] for p in got['probes']]}) see no GPU, their "
        f"weights on the CPU ({sum(p['transport']['cpu_landings'] for p in got['probes'])} leaves "
        f"landed there), 0 device objects held; {card}")


def rl_dreamer_cell(torch, rl, card, device):
    """rl-dreamer: train_dreamer on CartPole at tests/test_rl.py's config,
    the learner on the card, RL_DREAMER_RUN's bounded episodes; each
    world-model and actor-critic step timed."""
    from cluster_anywhere_tpu_torch.rl import dreamer
    from cluster_anywhere_tpu_torch.rl.env import CartPole

    times = {"wm_update": [], "ac_update": []}
    inner = {k: getattr(dreamer.DreamerV3Learner, k) for k in times}

    def timed(name):
        def call(self, *a):
            rl_sync(torch)
            t0 = time.perf_counter()
            out = inner[name](self, *a)
            rl_sync(torch)
            times[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return call

    t0 = time.perf_counter()
    for k in times:
        setattr(dreamer.DreamerV3Learner, k, timed(k))
    try:
        learner = rl.train_dreamer(CartPole, cfg=rl.DreamerConfig(**RL_DREAMER), **RL_DREAMER_RUN,
                                   device=None if device == "cuda" else device)
    finally:
        for k, fn in inner.items():
            setattr(dreamer.DreamerV3Learner, k, fn)
    wall = time.perf_counter() - t0
    stats = learner.last_stats
    check(learner.device.type == device and next(learner.wm.parameters()).device.type == device,
          f"[rl-dreamer] the learner is not on {device}")
    check(len(times["wm_update"]) > 0 and len(times["wm_update"]) == len(times["ac_update"]),
          f"[rl-dreamer] {len(times['wm_update'])} world-model and {len(times['ac_update'])} "
          f"actor-critic updates")
    check(all(np.isfinite(v) for v in stats.values()), f"[rl-dreamer] stats {stats}")
    rets = learner.episode_returns
    log(f"[rl-dreamer] train_dreamer on CartPole (DreamerConfig {RL_DREAMER}), "
        f"{RL_DREAMER_RUN['episodes']} episodes, {len(times['wm_update'])} updates, the learner "
        f"on the card: {wall:.1f} s; world-model update median "
        f"{np.median(times['wm_update']):.2f} ms, actor-critic update median "
        f"{np.median(times['ac_update']):.2f} ms; episode returns first 5 {rets[:5]}, last 5 "
        f"{rets[-5:]}; last stats {({k: round(v, 4) for k, v in stats.items()})}; {card}")


def memory_report():
    """The host's memory as the runtime's memory monitor reads it: the
    cgroup's usage where it has one, and the used share the monitor holds
    to its 0.95 threshold (above it the head kills a worker)."""
    from cluster_anywhere_tpu_torch.core import memory_monitor as mm

    parts = []
    for d, cur, lim in ((mm._CG2, "memory.current", "memory.max"),
                        (mm._CG1, "memory.usage_in_bytes", "memory.limit_in_bytes")):
        c, m = mm._read_int(os.path.join(d, cur)), mm._read_int(os.path.join(d, lim))
        if c is not None:
            limit = f"{m / 2**30:.2f} GiB" if m and m < mm._NO_LIMIT else "no limit"
            parts.append(f"{d}/{cur} {c / 2**30:.2f} GiB of {limit}")
            break
    used, total = mm.MemoryMonitor().sample() or (0, 0)
    parts.append(f"the monitor's used {used / 2**30:.2f} GiB of {total / 2**30:.2f} "
                 f"({used / max(total, 1):.3f}, kills above 0.95)")
    return "; ".join(parts)


def phase_rl(torch, attn, device="cuda"):
    """Phase 10, the RL library on a session of the port's runtime of its
    own: rl-learners, rl-ppo, rl-ppo-dag, rl-dreamer, each checked and
    logged as it ends.  device="cpu" rehearses it on the host (the card's
    checks then hold the CPU to itself)."""
    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch import rl
    from cluster_anywhere_tpu_torch.core import api
    from cluster_anywhere_tpu_torch.rl import algorithm
    from cluster_anywhere_tpu_torch.util import state

    t_phase = time.perf_counter()
    card = gpu_clocks("name,power.limit") if device == "cuda" else "cpu"
    zero_launch_counts(attn)
    # fp32 products in every learner, on both devices
    check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmuls are on")
    with watchdog(RL_DEADLINE_S, "the RL phase"):
        rl_learners_cell(torch, card, device)
    info = ca.init(num_cpus=4, **({} if device == "cuda" else {"num_gpus": 1}))
    log(f"[rl] host memory at the session's start: {memory_report()}")
    runner_cls = algorithm.EnvRunner
    try:
        check(info["resources"].get("GPU") == 1.0,
              f"the runtime detected {info['resources'].get('GPU')} GPUs, want 1")
        algorithm.EnvRunner = probe_runner_class()
        with watchdog(RL_DEADLINE_S, "the RL phase"):
            rpc = rl_ppo_cell(torch, ca, rl, False, "rl-ppo", device)
            rl_ppo_report("rl-ppo", rpc, card)
            dag = rl_ppo_cell(torch, ca, rl, True, "rl-ppo-dag", device)
            rl_ppo_report("rl-ppo-dag", dag, card)
            a, b = rpc["first"], dag["first"]
            check(len(a) == len(b) == RL_RUNNERS and all(
                sorted(x) == sorted(y) and x["metrics"] == y["metrics"] and all(
                    k == "metrics" or (x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]))
                    for k in x) for x, y in zip(a, b)),
                "[rl-ppo-dag] the first iteration's rollouts differ from rl-ppo's")
            tr = dag["transport"]
            landed = tr["cuda_landings" if device == "cuda" else "cpu_landings"]
            check(tr["leaves_landed"] == dag["leaves"] == landed > 0
                  and (device != "cuda" or tr["cpu_landings"] == 0),
                  f"[rl-ppo-dag] the driver's landings {tr}, {dag['leaves']} rollout leaves")
            log(f"[rl-ppo-dag] the first iteration's rollouts equal rl-ppo's bit for bit, "
                f"{rl_leaf_count(a)} leaves of {RL_RUNNERS} runners; every one of the "
                f"{dag['leaves']} rollout leaves landed on cuda in the driver, none on the CPU "
                f"(the driver's transport counters {tr}); iteration median "
                f"{np.median(dag['iter_ms']):.2f} ms against rl-ppo's "
                f"{np.median(rpc['iter_ms']):.2f} ms; {card}")
        algorithm.EnvRunner = runner_cls
        with watchdog(RL_DEADLINE_S, "the RL phase"):
            rl_dreamer_cell(torch, rl, card, device)
        pids = [w["pid"] for w in state.list_workers()] + [api._head_proc.pid]
        log(f"[rl] {heartbeat_report(api._session_dir)}")
        log(f"[rl] host memory at the session's end: {memory_report()}; the memory "
            f"monitor's kills {state._head('stats')['stats']['oom_kills']}")
    except BaseException:
        print_session_errors(api._session_dir)
        log(f"[rl] at the failure: {memory_report()}")
        try:
            log(f"[rl] the memory monitor's kills: {state._head('stats')['stats']['oom_kills']}")
        except Exception as e:
            log(f"[rl] the head's stats unreadable: {e!r}")
        raise
    finally:
        algorithm.EnvRunner = runner_cls
        ca.shutdown()
    wait_gone(pids, "the RL session")
    launches = launch_counts(attn)
    check(launches == (0, 0, 0), f"[rl] the flash kernels launched {launches} in this phase")
    log(f"[rl] phase 10 in {time.perf_counter() - t_phase:.1f} s; the flash kernels' launches in "
        f"it (fwd, dQ, dK/dV) {launches}; none of {len(pids)} processes of its session left")


# ----------------------------------------------------------------- phase 11
# Tune and Workflows, on a session of the port's runtime of their own: an
# ASHA search over the flagship's learning rate in GPU trial actors
# (tune-asha), PBT exploiting a checkpoint of params and AdamW state
# (tune-pbt), and a workflow whose GPU step survives a resume
# (workflow-gpu).  The trials and the step count the kernels' launches in
# their own processes; the driver's counts stay 0.

TW_DEADLINE_S = 600  # the whole phase, under one watchdog
TW_LRS = (1e-3, TRAIN_LR, 1e-4, 3e-5)  # started in this order: the likely best reaches a rung first
TW_ASHA = dict(max_t=12, grace_period=3, reduction_factor=2)
TW_ASHA_GPU, TW_PBT_GPU = 0.25, 0.5  # each trial's share of the card
TW_PBT_STEPS, TW_PBT_INTERVAL = 8, 4
TW_PBT_LRS = (1e-3, 1e-5)  # the leader first; the other exploits it at step 4
TW_PBT_MUTATIONS = (5e-4, 2e-3)
TW_TOL = {"step1_rel": 1e-6}


def tune_workflow_functions():
    """(asha trial, pbt trial, generate step, failing step), nested so that
    they travel to the actors and tasks by value.  Each trial step reports
    its loss, ms, the flash kernels' launches counted in its own process
    and the card's peak memory_allocated there."""

    def launches():
        import importlib

        attn = importlib.import_module("cluster_anywhere_tpu_torch.ops.attention")
        return (attn.flash_attention.launches, attn.flash_bwd_dq.launches,
                attn.flash_bwd_dkv.launches)

    def setup(config):
        """make_train_step at the trial's rate, the model from seed 0 and
        the train cell's fixed batch, as phase 5 builds them."""
        import numpy as np
        import torch

        from cluster_anywhere_tpu_torch.models import TransformerConfig, make_train_step

        torch.backends.cuda.matmul.allow_tf32 = False
        cfg, dev = TransformerConfig(**config["cfg"]), config["device"]
        step, init_state = make_train_step(cfg, learning_rate=config["lr"], device=dev)
        model, opt = init_state(0)
        ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (config["b"], config["t"] + 1))
        return step, model, opt, {"ids": torch.from_numpy(ids).to(dev)}

    def one_step(step, model, opt, batch, s):
        import time

        import torch

        before = launches()
        t0 = time.perf_counter()
        _, _, loss = step(model, opt, batch)
        loss = loss.item()  # ends in a synchronize
        cuda = batch["ids"].is_cuda
        return {"step": s, "loss": loss, "step_ms": (time.perf_counter() - t0) * 1e3,
                "launches": [a - b for a, b in zip(launches(), before)],
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else 0.0,
                "t_report": time.time()}

    def asha(config):
        import time

        from cluster_anywhere_tpu_torch import tune

        t0 = time.time()
        step, model, opt, batch = setup(config)
        build_s = time.time() - t0
        for s in range(1, config["steps"] + 1):
            tune.report(dict(one_step(step, model, opt, batch, s), build_s=build_s))

    def pbt(config):
        import hashlib
        import os
        import shutil
        import time

        from cluster_anywhere_tpu_torch import tune
        from cluster_anywhere_tpu_torch.models import load_train_state, train_state
        from cluster_anywhere_tpu_torch.train.checkpoint import tree_flatten

        step, model, opt, batch = setup(config)
        start, extra = 0, {}
        ck = tune.get_checkpoint()
        if ck is not None:
            t0 = time.perf_counter()
            tree = ck.load_pytree()
            load_train_state(model, opt, tree)
            start = int(tree["opt"]["count"])
            load_ms = (time.perf_counter() - t0) * 1e3
            h = hashlib.sha256()
            for leaf in tree_flatten(train_state(model, opt)["params"])[0]:
                h.update(leaf.detach().cpu().numpy().tobytes())
            extra = {"restored_from": ck.path, "restored_sha256": h.hexdigest(),
                     "load_ms": load_ms}
        for s in range(start + 1, config["steps"] + 1):
            metrics = dict(one_step(step, model, opt, batch, s), lr=config["lr"], **extra)
            extra = {}
            if s == config["steps"]:
                return metrics  # the final result: no perturbation follows it
            ckpt = None
            if s % config["interval"] == 0:
                if config["lr"] == config["leader"]:
                    # the one checkpoint an exploit restores: the leader's
                    ckpt = tune.Checkpoint(tune.make_temp_checkpoint_dir())
                    t0 = time.perf_counter()
                    ckpt.save_pytree(train_state(model, opt))
                    metrics["save_ms"] = (time.perf_counter() - t0) * 1e3
                    metrics["save_bytes"] = os.path.getsize(os.path.join(ckpt.path, "state.npz"))
                else:
                    # report a second after the leader did, so that this
                    # trial's exploit finds the leader's checkpoint of this
                    # step on record
                    lead = os.path.join(config["sync"], f"{s}_{config['leader']!r}")
                    deadline = time.monotonic() + 300
                    while not os.path.exists(lead):
                        if time.monotonic() > deadline:
                            raise TimeoutError(f"the leader never reported step {s}")
                        time.sleep(0.05)
                    time.sleep(1.0)
            tune.report(metrics, checkpoint=ckpt)
            if ckpt is not None:
                shutil.rmtree(ckpt.path)
                open(os.path.join(config["sync"], f"{s}_{config['lr']!r}"), "w").close()

    def generate_step(cfg, ids, lens, n_new, device, marker):
        """The workflow's GPU step: the generate cell on the flagship from
        seed 0; counts its runs in `marker`."""
        import importlib
        import time

        import torch

        from cluster_anywhere_tpu_torch.models.generate import generate
        from cluster_anywhere_tpu_torch.models.transformer import init_params

        with open(marker, "a") as f:
            f.write("x")
        attn = importlib.import_module("cluster_anywhere_tpu_torch.ops.attention")
        model = init_params(cfg, 0, device=device)
        before = attn.flash_attention.launches
        t0 = time.perf_counter()
        out = generate(model, torch.tensor(ids, device=device), cfg=cfg, max_new_tokens=n_new,
                       prompt_lens=torch.tensor(lens, device=device))
        tokens = out.cpu().numpy()
        return {"tokens": tokens, "launches": attn.flash_attention.launches - before,
                "ms": (time.perf_counter() - t0) * 1e3}

    def fail_once(out, marker):
        """The workflow's CPU step: fails on its first run."""
        import os

        if not os.path.exists(marker):
            open(marker, "w").close()
            raise RuntimeError("injected failure of the CPU step")
        return {"rows": int(out["tokens"].shape[0]), "launches": out["launches"]}

    return asha, pbt, generate_step, fail_once


def cfg_fields(cfg):
    """A model config's fields as builtins, its dtypes by name: a trial
    actor then unpickles its arguments without importing torch, which it
    does on its trainable's thread instead, while the controller, which
    creates the trial actors one after another, goes on to the next."""
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    for k in ("dtype", "param_dtype"):
        out[k] = str(out[k]).replace("torch.", "")
    return out


def tw_asha(cfg, device, b, t, storage):
    """The tune-asha cell: returns what the checks and logs need."""
    from cluster_anywhere_tpu_torch import tune

    asha, _, _, _ = tune_workflow_functions()

    class Starts(tune.Callback):
        """When each trial's actor was first asked for (the controller's
        on_trial_start, on the driver's clock)."""

        def __init__(self):
            self.at = {}

        def on_trial_start(self, trial):
            self.at.setdefault(trial.trial_id, time.time())

    starts = Starts()
    space = {"lr": tune.grid_search(list(TW_LRS)), "cfg": cfg_fields(cfg), "device": device,
             "b": b, "t": t, "steps": TW_ASHA["max_t"]}
    res = {"gpu": TW_ASHA_GPU} if device != "cpu" else {"cpu": 1}
    t_fit, t0 = time.time(), time.perf_counter()
    grid = tune.Tuner(
        tune.with_resources(asha, res), param_space=space,
        tune_config=tune.TuneConfig(metric="loss", mode="min", max_concurrent_trials=len(TW_LRS),
                                    scheduler=tune.ASHAScheduler(**TW_ASHA)),
        run_config=tune.RunConfig(name="tune-asha", storage_path=storage, callbacks=[starts]),
    ).fit()
    wall = time.perf_counter() - t0
    bv = tune.BasicVariantGenerator()
    bv.set_search_properties("loss", "min", space)
    want = [c["lr"] for c in iter(lambda: bv.suggest("t"), None)]
    return {"grid": grid, "wall": wall, "starts": starts.at, "want": want, "t_fit": t_fit}


def tw_pbt(cfg, device, b, t, storage):
    """The tune-pbt cell: returns what the checks and logs need."""
    from cluster_anywhere_tpu_torch import tune

    _, pbt, _, _ = tune_workflow_functions()
    sync = os.path.join(storage, "pbt-sync")
    os.makedirs(sync)
    space = {"lr": tune.grid_search(list(TW_PBT_LRS)), "leader": TW_PBT_LRS[0], "cfg": cfg_fields(cfg),
             "device": device, "b": b, "t": t, "steps": TW_PBT_STEPS,
             "interval": TW_PBT_INTERVAL, "sync": sync}
    res = {"gpu": TW_PBT_GPU} if device != "cpu" else {"cpu": 1}
    t0 = time.perf_counter()
    grid = tune.Tuner(
        tune.with_resources(pbt, res), param_space=space,
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", max_concurrent_trials=len(TW_PBT_LRS),
            scheduler=tune.PopulationBasedTraining(
                perturbation_interval=TW_PBT_INTERVAL, seed=0,
                hyperparam_mutations={"lr": list(TW_PBT_MUTATIONS)})),
        run_config=tune.RunConfig(name="tune-pbt", storage_path=storage),
    ).fit()
    return {"grid": grid, "wall": time.perf_counter() - t0}


def tw_workflow(torch, ca, cfg, device, storage):
    """The workflow-gpu cell: the generate step on the card, then a CPU
    step that fails once; resume finishes it from the stored step 1."""
    from cluster_anywhere_tpu_torch import workflow
    from cluster_anywhere_tpu_torch.workflow.storage import WorkflowStorage

    _, _, generate_step, fail_once = tune_workflow_functions()
    gpu = {"num_gpus": 1} if device != "cpu" else {"num_cpus": 1}
    gen = ca.remote(**gpu)(generate_step)
    cpu_step = ca.remote(num_cpus=1)(fail_once)
    ids, lens = generate_prompts(torch, cfg, 0, "cpu")
    runs, failed = os.path.join(storage, "wf-gpu-runs"), os.path.join(storage, "wf-gpu-failed")
    dag = cpu_step.bind(gen.bind(cfg, ids.numpy(), lens.numpy(), N_NEW, device, runs), failed)
    root = os.path.join(storage, "workflows")
    t0 = time.perf_counter()
    try:
        workflow.run(dag, workflow_id="wf-gpu", storage_root=root, max_step_retries=0)
        first_error = None
    except Exception as e:  # the CPU step's injected failure
        first_error = e
    wall = time.perf_counter() - t0
    status = workflow.get_status("wf-gpu", storage_root=root)
    t0 = time.perf_counter()
    out = workflow.resume("wf-gpu", storage_root=root)
    resume_s = time.perf_counter() - t0
    st = WorkflowStorage("wf-gpu", root)
    stored = [st.load_step(k) for k in st.completed_steps() if k.startswith("step_")]
    step1 = next(v for v in stored if isinstance(v, dict) and "tokens" in v)
    with open(runs) as f:
        n_runs = len(f.read())
    return {"first_error": first_error, "failed_status": status, "out": out, "step1": step1,
            "runs": n_runs, "wall": wall, "resume_s": resume_s,
            "status": workflow.get_status("wf-gpu", storage_root=root)}


def tw_report_asha(asha, ref, card, steps_want):
    """Checks and logs of tune-asha; returns the trials' launches."""
    grid = asha["grid"]
    check(grid.num_errors == 0, f"[tune-asha] trials failed: {grid.errors}")
    lrs = [r.config["lr"] for r in grid]
    check(lrs == asha["want"] == list(TW_LRS),
          f"[tune-asha] trial rates {lrs}, the generator's sequence {asha['want']}")
    hist = [r.metrics_history for r in grid]
    ran = [len(h) for h in hist]
    check(min(ran) < TW_ASHA["max_t"] and max(ran) == TW_ASHA["max_t"],
          f"[tune-asha] steps per trial {ran}: want at least one stopped before step "
          f"{TW_ASHA['max_t']} and one to reach it")
    for lr, h in zip(lrs, hist):
        check([m["step"] for m in h] == list(range(1, len(h) + 1)),
              f"[tune-asha] lr {lr:g} reported steps {[m['step'] for m in h]}")
        check(all(tuple(m["launches"]) == steps_want for m in h),
              f"[tune-asha] lr {lr:g}: a step launched {[m['launches'] for m in h]}, want "
              f"{steps_want} each")
    mine = hist[lrs.index(TRAIN_LR)][0]["loss"]
    rel = abs(mine - ref["train_loss1"]) / abs(ref["train_loss1"])
    startup = [h[0]["t_report"] - asha["starts"][r.metrics["trial_id"]] for r, h in zip(grid, hist)]
    step_ms = [float(np.median([m["step_ms"] for m in h[1:]])) for h in hist]
    peaks = [max(m["peak_gb"] for m in h) for h in hist]
    when = [(asha["starts"][r.metrics["trial_id"]] - asha["t_fit"], h[0]["t_report"] - asha["t_fit"],
             h[-1]["t_report"] - asha["t_fit"]) for r, h in zip(grid, hist)]
    launches = tuple(map(sum, zip(*(m["launches"] for h in hist for m in h))))
    log(f"[tune-asha] Tuner(with_resources(trainable, {{'gpu': {TW_ASHA_GPU}}})), ASHA "
        f"{TW_ASHA}, {len(TW_LRS)} trials at once sharing the card, the flagship from seed 0 on "
        f"the train cell's batch B{ref['b']} T{ref['t']}: rates {lrs} ran {ran} steps; trial "
        f"start-up (placed to first report) {', '.join(f'{x:.2f}' for x in startup)} s; ms a step "
        f"in a trial (median of steps 2 on) {', '.join(f'{x:.1f}' for x in step_ms)} against the "
        f"train cell's {ref['train_ms']:.2f} alone on the card ({len(TW_LRS)} trials share it: "
        f"not a scaling number); experiment wall {asha['wall']:.2f} s (each trial's actor ready, "
        f"first and last report, s after fit() began: "
        f"{'; '.join(', '.join(f'{x:.2f}' for x in w) for w in when)}); peak memory_allocated a "
        f"trial {', '.join(f'{x:.2f}' for x in peaks)} GB; step 1's loss at lr {TRAIN_LR:g} "
        f"{mine:.6f} vs the train cell's {ref['train_loss1']:.6f} (relative {rel:.3g}, limit "
        f"{TW_TOL['step1_rel']:g}); the trials' launches (fwd, dQ, dK/dV) {launches}; {card}")
    check(rel <= TW_TOL["step1_rel"], "[tune-asha] step 1's loss is off the train cell's")
    return launches


def tw_report_pbt(pbt, steps_want, card):
    """Checks and logs of tune-pbt; returns the trials' launches."""
    from cluster_anywhere_tpu_torch import train

    grid = pbt["grid"]
    check(grid.num_errors == 0, f"[tune-pbt] trials failed: {grid.errors}")
    hist = [r.metrics_history for r in grid]
    restored = [m for h in hist for m in h if "restored_sha256" in m]
    check(len(restored) >= 1, "[tune-pbt] no trial exploited another's checkpoint")
    for h in hist:
        # a trial may report a step or two more before its exploit lands;
        # from the restored step on it counts up to the last
        steps = [m["step"] for m in h]
        at = max([i for i, m in enumerate(h) if "restored_sha256" in m], default=0)
        check(steps[:TW_PBT_INTERVAL] == list(range(1, TW_PBT_INTERVAL + 1))
              and steps[at:] == list(range(steps[at], TW_PBT_STEPS + 1))
              and (at == 0 or steps[at] == TW_PBT_INTERVAL + 1),
              f"[tune-pbt] steps {[[m['step'] for m in h] for h in hist]}")
    import hashlib

    from cluster_anywhere_tpu_torch.train.checkpoint import tree_flatten

    digests = []
    for m in restored:
        src = train.Checkpoint(m["restored_from"]).load_pytree()
        h = hashlib.sha256()
        for leaf in tree_flatten(src["params"])[0]:
            h.update(leaf.tobytes())
        digests.append(h.hexdigest())
        check(h.hexdigest() == m["restored_sha256"],
              f"[tune-pbt] the params restored at step {m['step']} differ from their source "
              f"checkpoint {m['restored_from']}")
    for h in hist:
        losses = [m["loss"] for m in h]
        check(all(np.isfinite(losses)) and losses[-1] < losses[TW_PBT_INTERVAL - 1] < losses[0],
              f"[tune-pbt] the loss did not keep falling: {losses}")
    saves = [(m["save_ms"], m["save_bytes"]) for h in hist for m in h if "save_ms" in m]
    loads = [m["load_ms"] for m in restored]
    launches = tuple(map(sum, zip(*(m["launches"] for h in hist for m in h))))
    check(all(tuple(m["launches"]) == steps_want for h in hist for m in h),
          f"[tune-pbt] a step launched {[[m['launches'] for m in h] for h in hist]}")
    log(f"[tune-pbt] PopulationBasedTraining(perturbation_interval={TW_PBT_INTERVAL}), 2 trials "
        f"at {TW_PBT_GPU} GPU, rates {[r.config['lr'] for r in grid]} (started at "
        f"{list(TW_PBT_LRS)}), {TW_PBT_STEPS} steps: {len(restored)} exploit(s), restored params "
        f"sha256 {', '.join(d[:16] for d in digests)} equal to their source checkpoints'; loss "
        + "; ".join(' '.join(f"{m['loss']:.4f}" for m in h) for h in hist)
        + f"; save_pytree of params and AdamW state "
        + ", ".join(f"{ms:.0f} ms for {n / 1e9:.3f} GB" for ms, n in saves)
        + f"; load_pytree + load_train_state {', '.join(f'{x:.0f}' for x in loads)} ms; "
          f"experiment wall {pbt['wall']:.2f} s; the trials' launches {launches}; {card}")
    return launches


def tw_report_workflow(torch, wf, cfg, gen_tokens, device, card, per_layer):
    """Checks and logs of workflow-gpu; returns the step's forward launches."""
    step1 = wf["step1"]
    check(wf["first_error"] is not None and wf["failed_status"] == "FAILED",
          f"[workflow-gpu] the first run ended {wf['failed_status']} ({wf['first_error']!r}), "
          f"want FAILED on the CPU step's injected failure")
    check(wf["status"] == "SUCCEEDED" and wf["out"] == {"rows": B, "launches": step1["launches"]},
          f"[workflow-gpu] the resumed run gave {wf['out']} ({wf['status']})")
    check(wf["runs"] == 1, f"[workflow-gpu] the GPU step ran {wf['runs']} times, want once")
    check(step1["launches"] == per_layer,
          f"[workflow-gpu] the GPU step launched flash_fwd {step1['launches']} times")
    differing = tokens_vs_generate(torch, cfg, device, gen_tokens, step1["tokens"], "GPU step",
                                   "workflow-gpu")
    log(f"[workflow-gpu] a two-step workflow: the generate cell's 8 prompts +{N_NEW} on the "
        f"flagship in a num_gpus=1 task ({step1['ms']:.1f} ms of generate, {step1['launches']} "
        f"flash_fwd launches inside it), then a CPU task failing once: first run {wf['wall']:.2f} s "
        f"(FAILED), resume {wf['resume_s']:.3f} s from the stored step 1 (the GPU step ran "
        f"{wf['runs']} time in all, no new launch); tokens equal to the generate cell's on "
        f"{B - differing} of {B} rows, the rest near-ties; {card}")
    return step1["launches"]


def heartbeat_report(session_dir):
    """The head's widest heartbeat silence from a live worker this session
    (and whose), the silences past the bound it let pass because the
    worker's process was working, and the causes of the workers it
    declared dead (events.jsonl)."""
    from cluster_anywhere_tpu_torch.util import state

    try:
        st = state._head("stats")["stats"]
        gap = (f"{st.get('max_heartbeat_gap_s', 0.0):.2f} s "
               f"({st.get('max_heartbeat_gap_worker')})")
    except Exception as e:
        gap = f"unreadable ({e!r})"
    return (f"the widest heartbeat gap {gap}; silences past the bound with the worker at work "
            f"{session_events(session_dir, 'worker_silent', 'state', 'proc_state')}; workers "
            f"declared dead {worker_deaths(session_dir)}")


def session_events(session_dir, kind, *keys):
    """[(worker, *keys)] of the session's events of one kind."""
    out = []
    try:
        with open(os.path.join(session_dir or "", "events.jsonl")) as f:
            for line in f:
                ev = json.loads(line)
                if ev.get("event") == kind:
                    out.append((ev.get("worker_id"),) + tuple(ev.get(k) for k in keys))
    except (OSError, ValueError):
        pass
    return out


def worker_deaths(session_dir):
    """[(worker, cause)] of the session's worker_died events."""
    return session_events(session_dir, "worker_died", "cause")


def phase_tune_workflow(torch, attn, ref, device="cuda", cfg=None, b=TRAIN_B, t=TRAIN_T):
    """Phase 11, Tune and Workflows on a session of the port's runtime of
    their own: tune-asha, tune-pbt and workflow-gpu, each checked and
    logged as it ends, under one watchdog; no process of the session left
    after shutdown.  `ref` holds phase 5's step-1 loss and step ms and the
    generate cell's tokens.  device="cpu" with a small cfg rehearses it on
    the host.  Returns the launches in the trials and the step (fwd, dQ,
    dK/dV); the driver's must stay 0."""
    import shutil

    import cluster_anywhere_tpu_torch as ca
    from cluster_anywhere_tpu_torch.core import api
    from cluster_anywhere_tpu_torch.util import state

    cfg = cfg or flagship()
    card = gpu_clocks("name,power.limit") if device == "cuda" else "cpu"
    # on the host the wrappers take the plain versions: no launch to count
    per_layer = cfg.n_layers if device == "cuda" else 0
    steps_want = (per_layer,) * 3
    if ref is None:
        ref = tw_host_reference(torch, cfg, b, t)
    ref = dict(ref, b=b, t=t)
    storage = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "tune_workflow")
    shutil.rmtree(storage, ignore_errors=True)
    os.makedirs(storage)
    import gc

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
        log(f"[tune] the driver's memory_allocated at the phase's start "
            f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    t_phase = time.perf_counter()
    zero_launch_counts(attn)
    info = ca.init(num_cpus=6, **({} if device == "cuda" else {"num_gpus": 0}))
    try:
        if device == "cuda":
            check(info["resources"].get("GPU") == 1.0,
                  f"the runtime detected {info['resources'].get('GPU')} GPUs, want 1")
        with watchdog(TW_DEADLINE_S, "the Tune and Workflows phase"):
            launches = tw_report_asha(tw_asha(cfg, device, b, t, storage), ref, card, steps_want)
            pbt = tw_report_pbt(tw_pbt(cfg, device, b, t, storage), steps_want, card)
            launches = tuple(a + b_ for a, b_ in zip(launches, pbt))
            wf = tw_report_workflow(torch, tw_workflow(torch, ca, cfg, device, storage), cfg,
                                    ref["gen_tokens"], device, card, per_layer)
            launches = (launches[0] + wf,) + launches[1:]
        pids = [w["pid"] for w in state.list_workers()] + [api._head_proc.pid]
        log(f"[tune] {heartbeat_report(api._session_dir)}")
    except BaseException:
        print_session_errors(api._session_dir)
        raise
    finally:
        ca.shutdown()
        shutil.rmtree(storage, ignore_errors=True)
    wait_gone(pids, "the Tune session")
    driver = launch_counts(attn)
    log(f"[tune] phase 11 in {time.perf_counter() - t_phase:.1f} s; launches (fwd, dQ, dK/dV) in "
        f"the trials and the workflow's step {launches}, in the driver {driver}")
    check(driver == (0, 0, 0), f"the driver launched kernels in phase 11: {driver}")
    check(device != "cuda" or all(x > 0 for x in launches),
          f"a kernel did not launch in phase 11: {launches}")
    return launches


def tw_host_reference(torch, cfg, b, t):
    """What phases 3 and 5 give phase 11, computed here on the host for a
    rehearsal: step 1's loss and ms of the train cell's step, and the
    generate cell's tokens."""
    from cluster_anywhere_tpu_torch.models import make_train_step
    from cluster_anywhere_tpu_torch.models.generate import generate
    from cluster_anywhere_tpu_torch.models.transformer import init_params

    step, init_state = make_train_step(cfg, device="cpu")
    model, opt = init_state(0)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, t + 1))
    t0 = time.perf_counter()
    _, _, loss = step(model, opt, {"ids": torch.from_numpy(ids)})
    train_ms = (time.perf_counter() - t0) * 1e3
    ids_t, lens_t = generate_prompts(torch, cfg, 0, "cpu")
    out = generate(init_params(cfg, 0, device="cpu"), ids_t, cfg=cfg, max_new_tokens=N_NEW,
                   prompt_lens=lens_t)
    return {"train_loss1": loss.item(), "train_ms": train_ms, "gen_tokens": out.numpy()}


# ----------------------------------------------------------------- phase 12

OPS_DEADLINE_S = 600  # the whole phase, under one watchdog
OPS_WAIT_S = 180  # the bound on each CLI call, job and node wait of the phase
OPS_IDLE_S = 5  # ops-autoscale: AutoscalerConfig(idle_timeout_s=...), interval 1 s
OPS_STEPS, OPS_PREEMPT_AT = 12, 3  # ops-preempt: steps, the step after which the warning fires
OPS_KILL_AFTER_S = 60.0  # PreemptionSimulator's SIGKILL: past the drain's 30-s deadline
OPS_TOL = {"loss_rel": 1e-3, "rerun": 2}
OPS_COUNTERS = ("preempt_restarts_total", "preempt_barrier_acked_total",
                "budget_exempt_attempts_total")  # each must read 1 after the preemption

# The generate cell in a GPU actor.  One source for the job script of
# ops-up-job, which imports only the port, and for ops-autoscale, which
# runs it from this process (exec'd into a namespace of its own, so that
# the class travels to the worker by value).
OPS_GENERATOR = r'''
class Generator:
    """The generate cell on the flagship from seed 0 in an actor: the
    model built in __init__ (no card, no actor: there is no fallback),
    generate() returns the tokens, ms and the flash kernels' launches
    counted in this process."""

    def __init__(self, fields, device):
        import importlib
        import os

        import torch

        from cluster_anywhere_tpu_torch.models import TransformerConfig
        from cluster_anywhere_tpu_torch.models.transformer import init_params

        if device != "cpu" and not torch.cuda.is_available():
            raise RuntimeError("a GPU actor found no card (CUDA_VISIBLE_DEVICES="
                               f"{os.environ.get('CUDA_VISIBLE_DEVICES')!r})")
        self.cfg, self.device = TransformerConfig(**fields), device
        self.model = init_params(self.cfg, 0, device=device)
        self.attn = importlib.import_module("cluster_anywhere_tpu_torch.ops.attention")
        self.node = os.environ.get("CA_NODE_ID", "n0")

    def ready(self):
        return self.node

    def generate(self, ids, lens, n_new):
        import os
        import time

        import torch

        from cluster_anywhere_tpu_torch.models.generate import generate

        a = self.attn
        before = (a.flash_attention.launches, a.flash_bwd_dq.launches, a.flash_bwd_dkv.launches)
        t0 = time.perf_counter()
        out = generate(self.model, torch.tensor(ids, device=self.device), cfg=self.cfg,
                       max_new_tokens=n_new, prompt_lens=torch.tensor(lens, device=self.device))
        tokens = out.cpu().tolist()
        after = (a.flash_attention.launches, a.flash_bwd_dq.launches, a.flash_bwd_dkv.launches)
        return {"tokens": tokens, "ms": (time.perf_counter() - t0) * 1e3, "node": self.node,
                "launches": [x - y for x, y in zip(after, before)],
                "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
'''

# The job of ops-up-job: its driver joins the cluster (CA_ADDRESS), runs the
# generate cell in a num_gpus=1 actor and prints one JSON line.
OPS_JOB = r'''
import json
import os
import sys
import time

import numpy as np

import cluster_anywhere_tpu_torch as ca

here = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(here, "job.json")) as f:
    spec = json.load(f)
inp = np.load(os.path.join(here, "prompts.npz"))
ns = {"__name__": "ops_job_generator"}
exec(spec["generator"], ns)
ca.init(address=os.environ["CA_ADDRESS"])
try:
    t0 = time.perf_counter()
    gen = ca.remote(num_gpus=1)(ns["Generator"]).remote(spec["cfg"], spec["device"])
    ca.get(gen.ready.remote(), timeout=spec["wait_s"])
    ready_s = time.perf_counter() - t0
    out = ca.get(gen.generate.remote(inp["ids"].tolist(), inp["lens"].tolist(), spec["n_new"]),
                 timeout=spec["wait_s"])
    ca.kill(gen)
finally:
    ca.shutdown()
attn = sys.modules.get("cluster_anywhere_tpu_torch.ops.attention")  # never imported here
driver = ([attn.flash_attention.launches, attn.flash_bwd_dq.launches, attn.flash_bwd_dkv.launches]
          if attn else [0, 0, 0])
print("OPS_JOB " + json.dumps(dict(out, ready_s=ready_s, driver_launches=driver,
                                   driver_visible=os.environ.get("CUDA_VISIBLE_DEVICES"),
                                   driver_torch="torch" in sys.modules)))
'''


def ops_generator_class():
    """OPS_GENERATOR's class, defined in a namespace no worker imports."""
    ns = {"__name__": "ops_generator"}
    exec(OPS_GENERATOR, ns)
    return ns["Generator"]


def ops_cli(args, env, cwd):
    """One `python -m cluster_anywhere_tpu_torch.cli ...`, as a user types
    it; fails the phase on a non-zero exit.  Returns (stdout, s)."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "cluster_anywhere_tpu_torch.cli", *args], env=env,
                       cwd=cwd, capture_output=True, text=True, timeout=OPS_WAIT_S)
    s = time.perf_counter() - t0
    check(p.returncode == 0, f"[ops] `ca {' '.join(args)}` exited {p.returncode}: "
                             f"{p.stdout[-2000:]} {p.stderr[-3000:]}")
    return p.stdout, s


def http_json(url, timeout=30):
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def ops_events(session_dir):
    """The session's events.jsonl, minus heartbeat noise."""
    out = []
    with open(os.path.join(session_dir, "events.jsonl")) as f:
        for line in f:
            ev = json.loads(line)
            if ev.get("event") in ("node_draining", "node_drained", "node_died", "actor_migrating",
                                   "actor_alive", "actor_dead", "worker_died"):
                out.append(ev)
    return out


def ops_session_pids(session_dir):
    """The pids of a session's head, node agents and workers, read through
    this process's connection to it."""
    from cluster_anywhere_tpu_torch.util import state

    with open(os.path.join(session_dir, "head.ready")) as f:
        pids = [int(f.read())]
    pids += [n["pid"] for n in state._head("nodes")["nodes"] if n.get("pid")]
    return pids + [w["pid"] for w in state.list_workers() if w.get("pid")]


def ops_shutdown(c):
    """Ends a Cluster's session as `ca down` does (the head tells its
    agents and workers to exit), then Cluster.shutdown() kills whatever is
    left and removes the session."""
    from cluster_anywhere_tpu_torch.core.worker import try_global_worker

    w = try_global_worker()
    try:
        if w is not None:
            w.shutdown(stop_cluster=True)
    finally:
        c.shutdown()


def ops_up_job(torch, cfg, device, gen_tokens, card, per_layer, tmp):
    """ops-up-job: `ca up` (a head without a GPU, one node with one), `ca
    status`, `ca list nodes` and the dashboard, `ca submit` of a job that
    runs the generate cell in a num_gpus=1 actor, `ca jobs`, the job's logs
    through JobSubmissionClient, `ca down`; no process of the session left.
    Returns the actor's launches."""
    import re

    from cluster_anywhere_tpu_torch.jobs import JobSubmissionClient

    t_cell = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with open(os.path.join(tmp, "cluster.yaml"), "w") as f:
        f.write("head: {num_cpus: 2, num_gpus: 0}\n"
                "nodes:\n  - {count: 1, num_cpus: 2, num_gpus: 1}\n")
    ids, lens = generate_prompts(torch, cfg, 0, "cpu")
    np.savez(os.path.join(tmp, "prompts.npz"), ids=ids.numpy(), lens=lens.numpy())
    with open(os.path.join(tmp, "job.json"), "w") as f:
        json.dump({"cfg": cfg_fields(cfg), "device": device, "n_new": N_NEW, "wait_s": OPS_WAIT_S,
                   "generator": OPS_GENERATOR}, f)
    with open(os.path.join(tmp, "job.py"), "w") as f:
        f.write(OPS_JOB)
    out, up_s = ops_cli(["up", "cluster.yaml"], env, tmp)
    sdir = re.search(r"head up at (\S+)", out).group(1)
    connected, pids = False, []
    try:
        status, _ = ops_cli(["status", "--address", sdir], env, tmp)
        check(re.search(r"^  GPU: 1 / 1 available$", status, re.M),
              f"[ops-up-job] `ca status` shows no GPU 1: {status[:600]}")
        listed, _ = ops_cli(["list", "nodes", "--address", sdir], env, tmp)
        gpu_nodes = [n for n in json.loads(listed) if n["alive"] and n["resources"].get("GPU")]
        check(len(gpu_nodes) == 1 and not gpu_nodes[0]["is_head_node"]
              and gpu_nodes[0]["resources"]["GPU"] == 1.0,
              f"[ops-up-job] `ca list nodes` gives GPU nodes {gpu_nodes}")
        node = gpu_nodes[0]["node_id"]
        url = ops_cli(["dashboard", "--address", sdir], env, tmp)[0].strip()
        api_nodes = {n["node_id"]: n for n in http_json(url + "/api/nodes")}
        check(api_nodes[node]["resources"].get("GPU") == 1.0
              and api_nodes[node]["available"].get("GPU") == 1.0
              and not any(n["resources"].get("GPU") for k, n in api_nodes.items() if k != node),
              f"[ops-up-job] the dashboard's /api/nodes: {api_nodes}")
        submitted, submit_s = ops_cli(["submit", "--address", sdir, "--", "python", "job.py"],
                                      env, tmp)
        sid = re.search(r"submitted (\S+):", submitted).group(1)
        jobs, _ = ops_cli(["jobs", "--address", sdir], env, tmp)
        check(re.search(rf"^{re.escape(sid)}\s+SUCCEEDED\s", jobs, re.M),
              f"[ops-up-job] `ca jobs` does not show {sid} SUCCEEDED: {jobs}")
        rest = http_json(f"{url}/api/jobs/{sid}")
        check(rest["status"] == "SUCCEEDED", f"[ops-up-job] /api/jobs/{sid}: {rest}")
        client = JobSubmissionClient(sdir)
        connected = True
        logs = client.get_job_logs(sid)
        check(client.get_job_status(sid) == "SUCCEEDED", f"[ops-up-job] {sid}: {logs[-3000:]}")
        got = json.loads(re.search(r"^OPS_JOB (.*)$", logs, re.M).group(1))
        pids = ops_session_pids(sdir)
        log(f"[ops-up-job] {heartbeat_report(sdir)}")
    finally:
        if connected:
            import cluster_anywhere_tpu_torch as ca

            ca.shutdown()
        down = subprocess.run([sys.executable, "-m", "cluster_anywhere_tpu_torch.cli", "down",
                               "--address", sdir], env=env, cwd=tmp, capture_output=True,
                              text=True, timeout=OPS_WAIT_S)
    check(down.returncode == 0, f"[ops-up-job] `ca down` exited {down.returncode}: {down.stderr}")
    gone = wait_gone(pids, "the ops-up-job session")
    check(got["node"] == node,
          f"[ops-up-job] the actor ran on {got['node']}, not the GPU node {node}")
    check(got["launches"] == [per_layer, 0, 0],
          f"[ops-up-job] the actor launched (fwd, dQ, dK/dV) {got['launches']}, want "
          f"({per_layer}, 0, 0)")
    check(got["driver_launches"] == [0, 0, 0] and got["driver_visible"] == "",
          f"[ops-up-job] the job's driver launched {got['driver_launches']} with "
          f"CUDA_VISIBLE_DEVICES={got['driver_visible']!r}")
    differing = tokens_vs_generate(torch, cfg, device, gen_tokens, got["tokens"],
                                   "the job's actor", "ops-up-job")
    log(f"[ops-up-job] `ca up` (a head of 2 CPUs and no GPU, one node of 2 CPUs and 1 GPU) to the "
        f"GPU node alive {up_s:.2f} s; `ca status` GPU 1 / 1, `ca list nodes` and the dashboard's "
        f"/api/nodes GPU 1 on {node} alone; `ca submit -- python job.py` to SUCCEEDED "
        f"{submit_s:.2f} s (`ca jobs` and /api/jobs/{sid} SUCCEEDED), the num_gpus=1 actor ready "
        f"in {got['ready_s']:.2f} s on {got['node']} (CUDA_VISIBLE_DEVICES "
        f"{got['visible']!r}), generate {got['ms']:.1f} ms; the job's tokens (its logs through "
        f"JobSubmissionClient) equal to the generate cell's on {B - differing} of {B} rows, the "
        f"rest near-ties; launches (fwd, dQ, dK/dV) in the actor {tuple(got['launches'])}, in the "
        f"job's driver {tuple(got['driver_launches'])} (CUDA_VISIBLE_DEVICES "
        f"{got['driver_visible']!r}, torch imported {got['driver_torch']}); `ca down`: none of "
        f"{len(pids)} processes of the session left ({gone:.1f} s); the cell "
        f"{time.perf_counter() - t_cell:.1f} s; {card}")
    return tuple(got["launches"])


def ops_autoscale(torch, ca, cfg, device, gen_tokens, card, per_layer):
    """ops-autoscale: a Cluster whose head has no GPU, an Autoscaler over
    AgentNodeProvider with one GPU node type; a num_gpus=1 actor makes it
    launch the node, runs the generate cell there, and is killed; the node
    is terminated once idle.  Returns the actor's launches."""
    from cluster_anywhere_tpu_torch.autoscaler import (AgentNodeProvider, Autoscaler,
                                                       AutoscalerConfig, NodeType)
    from cluster_anywhere_tpu_torch.cluster_utils import Cluster

    t_cell = time.perf_counter()
    c = Cluster(head_resources={"CPU": 2})
    pids, asc = [], None
    try:
        c.connect()
        provider = AgentNodeProvider()
        asc = Autoscaler(provider, AutoscalerConfig(
            node_types=[NodeType("gpu1", {"CPU": 2.0, "GPU": 1.0}, max_nodes=1)],
            idle_timeout_s=OPS_IDLE_S, interval_s=1.0))
        asc.start()
        time.sleep(1.5)  # the autoscaler has read the head's demand once
        ids, lens = generate_prompts(torch, cfg, 0, "cpu")
        cls, made = ca.remote(num_gpus=1)(ops_generator_class()), []
        # the creation waits for the actor's placement, on a thread of its
        # own while this one watches for the node
        maker = threading.Thread(target=lambda: made.append(cls.remote(cfg_fields(cfg), device)),
                                 daemon=True)
        t0 = time.perf_counter()
        maker.start()
        node_s, deadline = None, time.monotonic() + OPS_WAIT_S
        while node_s is None and time.monotonic() < deadline:
            if any(n["alive"] and not n["is_head_node"] for n in ca.nodes()):
                node_s = time.perf_counter() - t0
            else:
                time.sleep(0.05)
        check(node_s is not None, "[ops-autoscale] no node joined for the pending GPU actor")
        maker.join(timeout=OPS_WAIT_S)
        check(made, "[ops-autoscale] the GPU actor was not created")
        gen = made[0]
        got = ca.get(gen.generate.remote(ids.tolist(), lens.tolist(), N_NEW), timeout=OPS_WAIT_S)
        result_s = time.perf_counter() - t0 - node_s
        nodes = list(provider.nodes.values())
        check(len(nodes) == 1 and got["node"] == nodes[0].node_id,
              f"[ops-autoscale] the actor ran on {got['node']}, the provider's nodes "
              f"{[n.node_id for n in nodes]}")
        pids = ops_session_pids(c.session_dir)
        ca.kill(gen)
        t_idle = time.perf_counter()
        deadline = time.monotonic() + OPS_IDLE_S + 10
        while nodes[0].handle.poll() is None and time.monotonic() < deadline:
            time.sleep(0.1)
        gone_s = time.perf_counter() - t_idle
        check(nodes[0].handle.poll() is not None and not provider.non_terminated_nodes(),
              f"[ops-autoscale] the idle node was not terminated within {OPS_IDLE_S + 10} s")
        alive = [n["node_id"] for n in ca.nodes() if n["alive"] and not n["is_head_node"]]
        check(not alive, f"[ops-autoscale] nodes alive after the termination: {alive}")
        log(f"[ops-autoscale] {heartbeat_report(c.session_dir)}")
    finally:
        if asc is not None:
            asc.stop()
        ops_shutdown(c)
    gone = wait_gone(pids, "the ops-autoscale session")
    check(got["launches"] == [per_layer, 0, 0],
          f"[ops-autoscale] the actor launched (fwd, dQ, dK/dV) {got['launches']}")
    differing = tokens_vs_generate(torch, cfg, device, gen_tokens, got["tokens"],
                                   "the autoscaled actor", "ops-autoscale")
    log(f"[ops-autoscale] Autoscaler(AgentNodeProvider(), node type {{'CPU': 2, 'GPU': 1}}, "
        f"idle_timeout_s {OPS_IDLE_S}, interval 1 s) over a head without a GPU: a num_gpus=1 "
        f"actor's demand to its node {nodes[0].node_id} alive {node_s:.2f} s, node alive to the "
        f"first result {result_s:.2f} s (generate {got['ms']:.1f} ms there); tokens equal to the "
        f"generate cell's on {B - differing} of {B} rows, the rest near-ties; launches in the "
        f"actor {tuple(got['launches'])}; the actor killed, the idle node terminated and its agent "
        f"gone {gone_s:.2f} s later (limit {OPS_IDLE_S + 10}); after shutdown none of "
        f"{len(pids)} processes of the session left ({gone:.1f} s); the cell "
        f"{time.perf_counter() - t_cell:.1f} s; {card}")
    return tuple(got["launches"])


def ops_preempt_fn():
    """ops-preempt's training loop, nested so that it travels by value: the
    flagship from seed 0 on an fsdp mesh as wide as the world, over
    TorchConfig's gloo group, the train cell's batch on every rank.  Rank 0
    arms the preemption after step config["arm_at"] of the first attempt;
    every rank saves a sharded checkpoint when the controller asks for one
    (should_checkpoint, agreed across the mesh) and after the last step; a
    resumed attempt loads it.  Each step reports its loss, ms, world and the
    flash kernels' launches summed over the ranks."""

    def loop(config):
        import json
        import os
        import time

        import torch
        import torch.distributed as dist

        from cluster_anywhere_tpu_torch import train
        from cluster_anywhere_tpu_torch.models import (TransformerConfig, load_train_state,
                                                       make_train_step, train_state,
                                                       train_state_specs)
        from cluster_anywhere_tpu_torch.parallel.mesh import MeshSpec, make_mesh, mesh_device

        t_start = time.time()
        torch.backends.cuda.matmul.allow_tf32 = False
        ctx = train.get_context()
        rank, world = ctx.get_world_rank(), ctx.get_world_size()
        with open(os.path.join(config["dir"], f"rank{rank}.node"), "w") as f:
            f.write(os.environ.get("CA_NODE_ID", "n0"))
        attn = __import__("cluster_anywhere_tpu_torch.ops.attention", fromlist=["x"])

        def launches():
            return [attn.flash_attention.launches, attn.flash_bwd_dq.launches,
                    attn.flash_bwd_dkv.launches]

        cfg = TransformerConfig(**config["cfg"])
        mesh = make_mesh(MeshSpec(fsdp=world), device=config["device"], backend="gloo")
        step, init_state = make_train_step(cfg, mesh)
        model, opt = init_state(0)
        specs = train_state_specs(cfg)
        start, load_s, loaded = 0, 0.0, None
        ck = train.get_checkpoint()
        if ck is not None:
            t0 = time.perf_counter()
            load_train_state(model, opt, ck.load_pytree_sharded(mesh=mesh, specs=specs))
            load_s = time.perf_counter() - t0
            with open(os.path.join(ck.path, "ops_meta.json")) as f:
                loaded = dict(json.load(f), path=ck.path)
            start = loaded["step"]
        ids = torch.tensor(config["ids"], device=mesh_device(mesh))
        for s in range(start + 1, config["steps"] + 1):
            before = launches()
            t0 = time.perf_counter()
            _, _, loss = step(model, opt, {"ids": ids})
            loss = loss.item()  # ends in a synchronize
            step_ms = (time.perf_counter() - t0) * 1e3
            got = torch.tensor([a - b for a, b in zip(launches(), before)], dtype=torch.int64)
            dist.all_reduce(got)  # every rank's launches (rank 0's reports count)
            metrics = {"step": s, "loss": loss, "step_ms": step_ms, "world": world,
                       "launches": got.tolist(), "attempt": ctx.attempt, "t_start": t_start,
                       "load_s": load_s, "loaded": loaded}
            if s == config["arm_at"] and start == 0 and rank == 0:
                open(config["go"], "w").close()
            want = torch.tensor([int(train.should_checkpoint())])
            dist.all_reduce(want, op=dist.ReduceOp.MAX)  # one boundary on every rank
            if want.item() or s == config["steps"]:
                ckpt = train.Checkpoint(train.shared_checkpoint_dir(s))
                t0 = time.perf_counter()
                ckpt.save_pytree_sharded(train_state(model, opt), mesh=mesh, specs=specs)
                dist.barrier()
                if rank == 0:
                    with open(os.path.join(ckpt.path, "ops_meta.json"), "w") as f:
                        json.dump({"step": s, "world": world}, f)
                metrics.update(save_ms=(time.perf_counter() - t0) * 1e3, t_save=time.time(),
                               barrier=bool(want.item()),
                               save_bytes=sum(os.path.getsize(os.path.join(d, n))
                                              for d, _, ns in os.walk(ckpt.path) for n in ns))
                train.report(metrics, checkpoint=ckpt)
            else:
                train.report(metrics)

    return loop


def ops_one_device_losses(torch, cfg, device, ids, start=0, state=None):
    """The losses of steps start + 1 to OPS_STEPS of the one-device trainer
    on the same batch, from the weights of seed 0 or from `state` (a train
    state tree, as a checkpoint holds it)."""
    from cluster_anywhere_tpu_torch.models import load_train_state, make_train_step

    step, init_state = make_train_step(cfg, device=device)
    model, opt = init_state(0)
    if state is not None:
        load_train_state(model, opt, state)
    batch = {"ids": torch.from_numpy(ids).to(device)}
    losses = [step(model, opt, batch)[2].item() for _ in range(start, OPS_STEPS)]
    del model, opt, step
    if device == "cuda":
        torch.cuda.empty_cache()
    return losses


def ops_preempt(torch, attn, cfg, device, card, b, t):
    """ops-preempt: two nodes of one GPU each (on one card they share it),
    TorchTrainer with 2 workers (min 1) on fsdp2, max_failures 0; after
    step OPS_PREEMPT_AT PreemptionSimulator warns rank 1's node.  Returns
    the workers' launches."""
    import shutil
    import tempfile

    from cluster_anywhere_tpu_torch import train
    from cluster_anywhere_tpu_torch.cluster_utils import Cluster
    from cluster_anywhere_tpu_torch.core import api
    from cluster_anywhere_tpu_torch.core.worker import TRAIN_STATS
    from cluster_anywhere_tpu_torch.util.chaos import PreemptionSimulator

    t_cell = time.perf_counter()
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, t + 1))
    t0 = time.perf_counter()
    want = ops_one_device_losses(torch, cfg, device, ids)
    ref_s = time.perf_counter() - t0
    zero_launch_counts(attn)
    tmp = tempfile.mkdtemp(prefix="ops_preempt_")
    go = os.path.join(tmp, "go")
    c = Cluster(head_resources={"CPU": 2})
    pids, sims, agent_exit = [], [], []
    try:
        nodes = [c.add_node(num_cpus=2, num_gpus=1) for _ in range(2)]
        c.connect()
        c.wait_for_nodes(3, timeout=OPS_WAIT_S)
        stats0 = dict(TRAIN_STATS)

        def preempter():
            deadline = time.monotonic() + OPS_DEADLINE_S
            while not os.path.exists(go) and time.monotonic() < deadline:
                time.sleep(0.02)
            with open(os.path.join(tmp, "rank1.node")) as f:
                victim = f.read()
            pid = next(n["pid"] for n in api.nodes() if n["node_id"] == victim)
            sims.append((PreemptionSimulator(victim, kill_after_s=OPS_KILL_AFTER_S).start(),
                         time.time(), victim))
            while _pid_alive(pid) and time.time() < sims[0][1] + OPS_KILL_AFTER_S + 5:
                time.sleep(0.1)
            agent_exit.append(time.time() - sims[0][1])

        th = threading.Thread(target=preempter, daemon=True)
        th.start()
        config = {"cfg": cfg_fields(cfg), "device": device, "ids": ids.tolist(), "steps": OPS_STEPS,
                  "arm_at": OPS_PREEMPT_AT, "go": go, "dir": tmp}
        result, fit_s, _ = tl_run(
            ops_preempt_fn(), config,
            train.ScalingConfig(num_workers=2, min_workers=1, max_workers=2, use_gpu=True,
                                gpus_per_worker=1.0),
            tmp, "ops-preempt", backend_config=train.TorchConfig(backend="gloo"),
            failure_config=train.FailureConfig(max_failures=0))
        th.join(timeout=OPS_KILL_AFTER_S + 10)
        driver = launch_counts(attn)
        counters = {k: TRAIN_STATS[k] - stats0.get(k, 0) for k in TRAIN_STATS}
        hist = [m for m in result.metrics_history if "loss" in m]
        after = [m for m in hist if m["world"] == 1]
        if result.error is None and after and after[0]["loaded"]:
            # the one-device run from the checkpoint the survivor loaded
            t0 = time.perf_counter()
            state = train.Checkpoint(after[0]["loaded"]["path"]).load_pytree_sharded()
            want_resumed = ops_one_device_losses(torch, cfg, device, ids, after[0]["step"] - 1,
                                                 state)
            del state
            ref_s += time.perf_counter() - t0
        pids = ops_session_pids(c.session_dir)
        events = [(e["event"], round(e["ts"] - sims[0][1], 2),
                   e.get("node_id") or e.get("actor_id"))
                  for e in ops_events(c.session_dir) if sims and e["ts"] >= sims[0][1]]
        log(f"[ops-preempt] {heartbeat_report(c.session_dir)}")
    finally:
        for sim, _, _ in sims:
            sim.stop()
        ops_shutdown(c)
        shutil.rmtree(tmp, ignore_errors=True)
    gone = wait_gone(pids, "the ops-preempt session")
    check(result.error is None, f"[ops-preempt] the fit failed: {result.error!r}")
    check(driver == (0, 0, 0), f"[ops-preempt] the driver launched {driver} during the fit")
    check(len(sims) == 1 and sims[0][2] in nodes,
          f"[ops-preempt] the preemption did not fire on a node of the gang: {sims}")
    sim, t_warn, victim = sims[0]
    steps = [m["step"] for m in hist]
    check(sorted(set(steps)) == list(range(1, OPS_STEPS + 1))
          and len(steps) - OPS_STEPS <= OPS_TOL["rerun"],
          f"[ops-preempt] steps reported {steps}: want 1-{OPS_STEPS}, at most "
          f"{OPS_TOL['rerun']} run again")
    check({k: counters.get(k) for k in OPS_COUNTERS} == dict.fromkeys(OPS_COUNTERS, 1),
          f"[ops-preempt] counters {counters}")
    barrier = [m for m in hist if m.get("barrier")]
    loaded = after[0]["loaded"] if after else None
    check(len(barrier) == 1 and barrier[0]["world"] == 2 and loaded is not None
          and (loaded["step"], loaded["world"]) == (barrier[0]["step"], 2)
          and after[-1]["step"] == OPS_STEPS
          and all(m["world"] == 1 for m in hist[hist.index(after[0]):]),
          f"[ops-preempt] the barrier checkpoints {[(m['step'], m['world']) for m in barrier]}, "
          f"then world 1 from {loaded}")
    # world 2 from seed 0 against the one-device run from seed 0; world 1
    # against the one-device run from the checkpoint it loaded (the same
    # weights and batch: a 12-step run that memorises its batch amplifies
    # the reductions' order, so from seed 0 the later steps drift apart)
    pairs = [(m, want[m["step"] - 1]) for m in hist if m["world"] == 2]
    worst = max(abs(m["loss"] - w) / abs(w) for m, w in pairs + list(zip(after, want_resumed)))
    drift = max(abs(m["loss"] - want[m["step"] - 1]) / abs(want[m["step"] - 1]) for m in after)
    check(worst <= OPS_TOL["loss_rel"],
          f"[ops-preempt] a step's loss is {worst:.3g} relative off the one-device run's "
          f"(limit {OPS_TOL['loss_rel']:g}): {[(m['step'], m['world'], m['loss']) for m in hist]} "
          f"vs {want} from seed 0 and {want_resumed} from the checkpoint")
    launches = tuple(map(sum, zip(*(m["launches"] for m in hist))))
    per_rank = cfg.n_layers if device == "cuda" else 0  # each kernel, a step, a rank
    check(all(tuple(m["launches"]) == (per_rank * m["world"],) * 3 for m in hist),
          f"[ops-preempt] launches a step {[m['launches'] for m in hist]}")
    two = [m["step_ms"] for m in hist if m["world"] == 2][1:]
    one = [m["step_ms"] for m in after][1:]
    log(f"[ops-preempt] TorchTrainer, 2 workers on nodes {nodes} (1 GPU each, sharing the card), "
        f"min_workers 1, FailureConfig(max_failures=0), fsdp2 over TorchConfig's gloo group, the "
        f"flagship at {cfg.n_layers} layers from seed 0 on the train cell's batch B{b} T{t}: the "
        f"warning (SIGTERM to {victim}'s agent) after step {OPS_PREEMPT_AT}, the barrier "
        f"checkpoint at step {barrier[0]['step']} {barrier[0]['t_save'] - t_warn:.2f} s later "
        f"(save_pytree_sharded {barrier[0]['save_ms']:.0f} ms for "
        f"{barrier[0]['save_bytes'] / 1e9:.3f} GB); restart to world 1 "
        f"{after[0]['t_start'] - barrier[0]['t_save']:.2f} s, load "
        f"{after[0]['load_s']:.2f} s; steps reported {steps} ({len(steps) - OPS_STEPS} run again); "
        f"step ms (median from each world's second) at world 2 "
        f"{float(np.median(two)) if two else float('nan'):.1f}, at world 1 "
        f"{float(np.median(one)) if one else float('nan'):.1f}; fit {fit_s:.2f} s; counters "
        f"{ {k: counters[k] for k in OPS_COUNTERS} }; "
        f"losses within {worst:.3g} relative of the one-device run's on the same weights (world 2: "
        f"from seed 0; world 1: from the checkpoint it loaded; limit {OPS_TOL['loss_rel']:g}; both "
        f"runs {ref_s:.1f} s here; world 1 against the run from seed 0 {drift:.3g}); the drain's "
        f"events after the warning (s) {events}; the agent exited {agent_exit[0]:.2f} s after the "
        f"warning, PreemptionSimulator's SIGKILL (at {OPS_KILL_AFTER_S:g} s) fired "
        f"{sim.sigkilled}; "
        f"the workers' launches (fwd, dQ, dK/dV) {launches}, the driver's {driver}; after shutdown "
        f"none of {len(pids)} processes of the session left ({gone:.1f} s); the cell "
        f"{time.perf_counter() - t_cell:.1f} s; {card}")
    return launches


def phase_cluster_ops(torch, attn, gen_tokens, device="cuda", cfg=None, b=TRAIN_B, t=TRAIN_T):
    """Phase 12, the operator's surface, each cell on a session of its own
    under one watchdog: ops-up-job, ops-autoscale, ops-preempt.
    `gen_tokens` are the generate cell's tokens (phase 3).  device="cpu"
    with a small cfg rehearses it on the host.  Returns the launches in
    the actors and workers (fwd, dQ, dK/dV); the driver's must stay 0."""
    import shutil
    import tempfile

    import cluster_anywhere_tpu_torch as ca

    cfg = cfg or flagship()
    card = gpu_clocks("name,power.limit") if device == "cuda" else "cpu"
    per_layer = cfg.n_layers if device == "cuda" else 0
    if gen_tokens is None:
        ids, lens = generate_prompts(torch, cfg, 0, device)
        from cluster_anywhere_tpu_torch.models.generate import generate
        from cluster_anywhere_tpu_torch.models.transformer import init_params

        gen_tokens = generate(init_params(cfg, 0, device=device), ids, cfg=cfg,
                              max_new_tokens=N_NEW, prompt_lens=lens).cpu().numpy()
    import gc

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="ops_")
    with watchdog(OPS_DEADLINE_S, "the operator's phase"):
        zero_launch_counts(attn)
        try:
            job = ops_up_job(torch, cfg, device, gen_tokens, card, per_layer, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        scaled = ops_autoscale(torch, ca, cfg, device, gen_tokens, card, per_layer)
        driver = launch_counts(attn)
        check(driver == (0, 0, 0), f"the driver launched kernels in phase 12: {driver}")
        pre = ops_preempt(torch, attn, cfg, device, card, b, t)
    launches = tuple(map(sum, zip(job, scaled, pre)))
    log(f"[ops] phase 12 in {time.perf_counter() - t_phase:.1f} s; launches (fwd, dQ, dK/dV) in "
        f"the actors and the workers {launches} (ops-up-job {job}, ops-autoscale {scaled}, "
        f"ops-preempt {pre}), in the driver none (ops-up-job, ops-autoscale and ops-preempt's fit)")
    check(device != "cuda" or all(x > 0 for x in launches),
          f"a kernel did not launch in phase 12: {launches}")
    return launches


# ----------------------------------------------------------------- phase 13

MB_DEADLINE_S = 75  # the whole phase, under one watchdog: the script's time limit
MB_REQUESTS = 10  # each serve arm of run_dag_plane(quick=True): 2 warm-up and 8 timed


def phase_lint_microbenchmark(torch, attn, device="cuda"):
    """Phase 13, under one watchdog: `ca lint --format json` in a
    subprocess (exit 0, no finding; it runs beside the rest), and the port's
    run_dag_plane(quick=True) on `device`, its replicas' class swapped for
    counting_ingress() (the module's build_continuous_llm_deployment
    wrapped from here) and each replica probed just before the runner
    deletes it, every SSE request's status and event count read through
    the module's _sse_request.  Both serve arms must answer every request
    with HTTP 200 and equal event counts (greedy decoding), the compiled
    arm on the compiled stream and the RPC arm not.  device="cpu"
    rehearses it on the host.  Returns the replicas' forward launches."""
    root = os.path.dirname(os.path.abspath(__file__))
    t_phase = time.perf_counter()
    with watchdog(MB_DEADLINE_S, "phase 13 (ca lint and the microbenchmark's DAG plane)"):
        lint = subprocess.Popen([sys.executable, "-m", "cluster_anywhere_tpu_torch.cli", "lint",
                                 "--format", "json"], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, cwd=root)
        try:
            launches = phase_13_dag_plane(attn, device)
        finally:
            out, err = lint.communicate(timeout=60)
        t_lint = time.perf_counter() - t_phase
        check(lint.returncode == 0, f"ca lint exited {lint.returncode}: {out[-2000:]} {err[-2000:]}")
        report = json.loads(out)
        with open(os.path.join(root, "docs", "PROTOCOL_CONTRACT_TORCH.json")) as f:
            contract = json.load(f)
        check(report["ok"] and not report["findings"], f"ca lint found {report['counts']}")
        log(f"[lint] ca lint --format json: exit 0 (read {t_lint:.1f} s into the phase), "
            f"{len(report['findings'])} findings ({report['suppressed']} pragma-suppressed), "
            f"the contract {len(contract['methods'])} RPC methods over "
            f"{len(contract['surfaces'])} surfaces")
    log(f"[mb-dag] phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_13_dag_plane(attn, device):
    """run_dag_plane(quick=True) with its replicas counted and probed, and
    its checks (phase_lint_microbenchmark).  Returns the replicas' forward
    launches."""
    from cluster_anywhere_tpu_torch import microbenchmark as mb
    from cluster_anywhere_tpu_torch import serve
    from cluster_anywhere_tpu_torch.core import api
    from cluster_anywhere_tpu_torch.llm import serve_llm
    from cluster_anywhere_tpu_torch.util import state

    requests, probes, built, pids = [], [], [], []
    build, delete, sse, shutdown = serve_llm.build_continuous_llm_deployment, serve.delete, \
        mb._sse_request, api.shutdown

    def counted_build(*args, **kw):
        built.append(time.perf_counter() - t0)
        app = build(*args, **kw)
        app.deployment.func_or_class = counting_ingress()  # same options, the probe added
        return app

    def probed_delete(name):
        if name == "llmdag":
            handle = serve.get_app_handle(name).options(method_name="probe")
            probes.append(handle.remote().result(timeout_s=30))
        return delete(name)

    def counted_sse(host, port, path, body=None, timeout=120.0):
        got = sse(host, port, path, body, timeout)
        requests.append((os.environ.get("CA_SERVE_COMPILED_DAG"), got[0], got[3],
                         time.perf_counter() - t0))
        return got

    def noted_shutdown():
        pids.extend([w["pid"] for w in state.list_workers()] + [api._head_proc.pid])
        return shutdown()

    serve_llm.build_continuous_llm_deployment = counted_build
    serve.delete, mb._sse_request, api.shutdown = probed_delete, counted_sse, noted_shutdown
    zero_launch_counts(attn)
    t0 = time.perf_counter()
    try:
        rows = mb.run_dag_plane(quick=True, device=None if device == "cuda" else device)
    finally:
        serve_llm.build_continuous_llm_deployment = build
        serve.delete, mb._sse_request, api.shutdown = delete, sse, shutdown
    dag_s = time.perf_counter() - t0
    driver = launch_counts(attn)
    gone_s = wait_gone(pids, "run_dag_plane's three sessions")
    values = {name: value for name, value, _ in rows}  # the runner printed each row
    arms = {flag: [(st, n) for f, st, n, _ in requests if f == flag] for flag in ("0", "1")}
    answered = {flag: [at for f, _, _, at in requests if f == flag] for flag in ("0", "1")}
    check([len(a) for a in arms.values()] == [MB_REQUESTS] * 2 and
          all(st == 200 and n > 0 for a in arms.values() for st, n in a),
          f"run_dag_plane's serve arms did not answer every request: {arms}")
    check(arms["0"] == arms["1"], f"the two arms' event counts differ: {arms}")
    check(values["dag serve rpc-stream events"] == values["dag serve compiled events"] > 0,
          f"the two arms' event rows differ: {values}")
    check(len(probes) == 2 and all(p["pid"] != os.getpid() for p in probes),
          f"the two replicas were not probed in processes of their own: {probes}")
    check(probes[0]["handshakes"] == 0 and probes[1]["handshakes"] >= MB_REQUESTS,
          f"dag_stream handshakes (rpc-stream, compiled) "
          f"{[p['handshakes'] for p in probes]}: want 0 and >= {MB_REQUESTS}")
    check(driver == (0, 0, 0), f"the driver launched kernels in phase 13: {driver}")
    launches = sum(p["launches"] for p in probes)
    check(device != "cuda" or (all(p["launches"] > 0 for p in probes) and
                               all(p["params"].startswith("cuda") for p in probes)),
          f"a replica of run_dag_plane did not run flash_fwd on the card: {probes}")
    log(f"[mb-dag] run_dag_plane(quick=True) in {dag_s:.1f} s: {MB_REQUESTS} requests an arm, "
        f"all HTTP 200, {arms['1'][-1][1]} events a request in both arms; replicas "
        f"{[(p['gpu'], p['params']) for p in probes]}, flash_fwd launches (rpc-stream, compiled) "
        f"{[p['launches'] for p in probes]}, dag_stream handshakes "
        f"{[p['handshakes'] for p in probes]}; TTFT p50/p99 rpc-stream "
        f"{values['dag serve rpc-stream TTFT p50']:.1f}/{values['dag serve rpc-stream TTFT p99']:.1f}"
        f" ms, compiled {values['dag serve compiled TTFT p50']:.1f}/"
        f"{values['dag serve compiled TTFT p99']:.1f} ms; none of the {len(pids)} processes "
        f"(heads and workers) of its three sessions left {gone_s:.1f} s after it ended")
    log(f"[mb-dag] timeline (s from the runner's start): rpc-stream "
        f"replica built {built[0]:.1f}, first answer {answered['0'][0]:.1f}, last "
        f"{answered['0'][-1]:.1f}; compiled replica built {built[1]:.1f}, first answer "
        f"{answered['1'][0]:.1f}, last {answered['1'][-1]:.1f}; the runner ended {dag_s:.1f}")
    return launches


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
    replica_fwd, compiled_sse = phase_serve_http(torch, attn, cfg, server)
    launches = (launches[0] + replica_fwd,) + launches[1:]
    # the processor and train-data cells: the actor's launches read inside
    # it, the train-data launches between zeroed counts
    data, _, train_data_ms = phase_data(torch, attn, cfg, train_ms)
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

    # the parallel stack, on ranks of their own: this process's models go first
    gen_tokens, server_tokens = out.cpu().numpy(), server["tokens"]
    del server, out, mout
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    par = phase_parallel(torch, attn)
    launches = tuple(map(sum, zip(launches, par)))
    # the Train library, on a session of its own: its workers' launches
    tl = phase_train_lib(torch, attn, {"train_ms": train_ms, "train_data_ms": train_data_ms})
    launches = tuple(map(sum, zip(launches, tl)))
    # the device plane, on a session of its own: the actors' and the RPC
    # wave replica's forward launches
    dp = phase_device_plane(torch, attn, flagship(), gen_tokens, server_tokens, compiled_sse)
    launches = (launches[0] + dp,) + launches[1:]
    # the RL library, on a session of its own: no flash kernel on its path
    phase_rl(torch, attn)
    # Tune and Workflows, on a session of their own: the trials' and the
    # workflow step's launches
    tw = phase_tune_workflow(torch, attn, {"train_loss1": STEP1_LOSS["train"],
                                           "train_ms": train_ms, "gen_tokens": gen_tokens})
    launches = tuple(map(sum, zip(launches, tw)))
    # the operator's surface, each cell on a session of its own: the launches
    # in the job's actor, the autoscaled actor and the preempted gang's workers
    ops = phase_cluster_ops(torch, attn, gen_tokens)
    launches = tuple(map(sum, zip(launches, ops)))
    # ca lint, and the microbenchmark's DAG plane: its replicas' launches
    mb_fwd = phase_lint_microbenchmark(torch, attn)
    launches = (launches[0] + mb_fwd,) + launches[1:]
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
