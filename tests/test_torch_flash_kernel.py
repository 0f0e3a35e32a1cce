"""The flash-attention CUDA kernels (cluster_anywhere_tpu_torch/ops/csrc/
flash_fwd.cu, and the dQ and dK/dV kernels of flash_bwd.cu) against their
plain PyTorch versions, on the card.  The tests marked `gpu` skip without
a GPU (the kernels have no CPU mode); the unmarked tests check, with the
plain versions alone, that the inputs and the bf16 tolerances used on the
card would catch a kernel that mixes up keys.  This file imports no JAX,
so it runs where only the port is installed:

    python -m pytest tests/test_torch_flash_kernel.py -q -m gpu
"""

import importlib

import numpy as np
import pytest
import torch

tattn = importlib.import_module("cluster_anywhere_tpu_torch.ops.attention")


# (T, T_kv, causal, padded)
CASES = [(200, 200, True, True), (200, 200, False, False), (64, 130, True, True), (130, 64, False, True)]
TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (2e-2, 1e-3)}  # (O, LSE)


def _qkv(t, t_kv, seed, d, b=2, h=3):
    """Unit-variance q, k, v: scores of unit variance, so each softmax row
    is peaked enough that O follows which V row each key maps to."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, n, h, d)).astype(np.float32) for n in (t, t_kv, t_kv))


def _pad(t_kv, padded, device):
    return torch.tensor([min(5, t_kv - 1), 0], device=device) if padded else None


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("t,t_kv,causal,padded", CASES)
def test_flash_kernel_matches_plain_on_card(cuda, dtype, d, t, t_kv, causal, padded):
    """Tolerances: fp32 O 1e-4, LSE 1e-5 (full fp32 in both); bf16 O 2e-2
    (bf16 output; P enters P.V as two bf16 parts), LSE 1e-3."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(a, device=cuda).to(dt) for a in _qkv(t, t_kv, seed=d, d=d))
    pad = _pad(t_kv, padded, cuda)
    before = tattn.flash_attention.launches
    o, lse = tattn.flash_attention(q, k, v, causal=causal, pad=pad, return_lse=True)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == before + 1
    po, plse = tattn._flash_attention_plain(q, k, v, causal=causal, scale=d ** -0.5, pad=pad)
    tol_o, tol_lse = TOL[dt]
    torch.testing.assert_close(o.float(), po.float(), atol=tol_o, rtol=0)
    real = plse > tattn.NEG_INF / 2
    torch.testing.assert_close(lse[real], plse[real], atol=tol_lse, rtol=0)
    assert torch.all(lse[~real] == tattn.NEG_INF)


@pytest.mark.parametrize("xor", [1, 8])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("t,t_kv,causal,padded", CASES)
def test_bf16_tolerance_rejects_mis_mapped_v(d, t, t_kv, causal, padded, xor):
    """On the card's bf16 inputs, a P.V that reads V of key `key ^ xor`
    (adjacent keys, or the two halves of a 16-key mma step, swapped) moves O
    far past the O tolerance, also on the later query rows whose softmax
    spans many keys; so the on-card comparison would reject such a kernel."""
    q, k, v = (torch.tensor(a).bfloat16() for a in _qkv(t, t_kv, seed=d, d=d))
    pad = _pad(t_kv, padded, "cpu")
    keys = torch.arange(t_kv)
    swapped = torch.where((keys ^ xor) < t_kv, keys ^ xor, keys)
    o, _ = tattn._flash_attention_plain(q, k, v, causal=causal, scale=d ** -0.5, pad=pad)
    o_bad, _ = tattn._flash_attention_plain(q, k, v[:, swapped], causal=causal, scale=d ** -0.5, pad=pad)
    err_late_rows = (o_bad.float() - o.float())[:, t // 2:].abs().max().item()
    assert err_late_rows > 10 * TOL[torch.bfloat16][0]


@pytest.mark.gpu
def test_flash_kernel_raises_on_what_it_does_not_take(cuda):
    q, k, v = (torch.tensor(a, device=cuda) for a in _qkv(8, 8, seed=0, d=24))
    with pytest.raises(ValueError):
        tattn.flash_attention(q, k, v)


@pytest.mark.gpu
def test_flash_kernel_reads_strided_views(cuda):
    """q, k, v as views into one fused [B, T, H, 3D] projection: the kernel
    reads them through their strides, and agrees with contiguous copies."""
    fused = torch.randn(2, 96, 4, 3 * 64, device=cuda).bfloat16()
    q, k, v = fused[..., :64], fused[..., 64:128], fused[..., 128:]
    assert not q.is_contiguous()
    o = tattn.flash_attention(q, k, v, causal=True)
    ref = tattn.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=True)
    torch.cuda.synchronize()
    assert torch.equal(o, ref)


# ------------------------------------------------------------------ backward
#
# The kernels against the plain version row by row: each gradient row (one
# query or key of one head, D values) is held to its own norm,
#   ||got_r - want_r|| / max(||want_r||, 0.1 * RMS over rows of ||want_r||),
# so that a fault on the small late rows of a causal sequence (the last keys
# are seen by few queries) reads as O(1) and not as a fraction of the first
# rows' size.  Rows below the floor are held in absolute terms: there a
# sound kernel's error follows the size of the terms summed, not of their
# sum (dQ of a row that sees one key is zero by cancellation).  Limits: fp32 1e-4 (full fp32 in both; summation
# order differs); bf16 2e-2 (the gradients are rounded to bf16, 2^-8
# relative, and the kernels round P and dS to bf16 before their products,
# as FA2 does).

ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FLAGSHIP_T = (1024, 1024, True, False)  # the flagship training step's attention, cut to B 2, H 3


def _bwd_inputs(t, t_kv, seed, d, dt, device, padded):
    q, k, v = (torch.tensor(a, device=device).to(dt) for a in _qkv(t, t_kv, seed=seed, d=d))
    pad = _pad(t_kv, padded, device)
    o, lse = tattn._flash_attention_plain(q, k, v, causal=True, scale=d ** -0.5, pad=pad)
    rng = np.random.default_rng(seed + 1)
    do = torch.tensor(rng.standard_normal(o.shape).astype(np.float32), device=device).to(dt)
    return q, k, v, pad, do


def _row_errs(got, want):
    errs = []
    for g, w in zip(got, want):
        diff, norm = (g.float() - w.float()).norm(dim=-1), w.float().norm(dim=-1)
        floor = 0.1 * norm.square().mean().sqrt()
        errs.append((diff / norm.clamp(min=floor.item())).max().item())
    return errs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("t,t_kv,causal,padded", CASES)
def test_flash_bwd_kernels_match_plain_on_card(cuda, dtype, d, t, t_kv, causal, padded):
    dt = getattr(torch, dtype)
    q, k, v, pad, do = _bwd_inputs(t, t_kv, d, d, dt, cuda, padded)
    scale = d ** -0.5
    o, lse = tattn.flash_attention(q, k, v, causal=causal, pad=pad, return_lse=True)
    dlse = torch.randn(lse.shape, device=cuda)
    delta = tattn._bwd_delta(o, do, dlse)
    before = (tattn.flash_bwd_dq.launches, tattn.flash_bwd_dkv.launches)
    dq = tattn.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale, pad=pad)
    dk, dv = tattn.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale, pad=pad)
    torch.cuda.synchronize()
    assert (tattn.flash_bwd_dq.launches, tattn.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    assert dq.dtype == dk.dtype == dv.dtype == dt
    want = tattn._flash_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale, pad=pad, dlse=dlse)
    errs = _row_errs((dq, dk, dv), want)
    assert max(errs) <= ROW_TOL[dt], errs


# Shapes that cross the Hopper kernels' tiles (dK/dV: 128-key blocks and
# 64-row query tiles; dQ: 128-row blocks and 64-key tiles): (B, T, T_kv, H,
# D, causal, pad of batch row 0).  A pad of 150 crosses the first 128-key
# block; T_kv 520 and T 520 leave ragged last tiles; the last is the
# flagship training step's attention.
HOPPER_CASES = [
    (b, t, t_kv, h, d, causal, pad0)
    for b, t, t_kv, h, causal, pad0 in [(2, 333, 333, 3, True, 150), (2, 96, 520, 3, False, None),
                                        (2, 520, 96, 3, True, None)]
    for d in (64, 128)
] + [(8, 1024, 1024, 8, 128, True, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,t_kv,h,d,causal,pad0", HOPPER_CASES)
def test_flash_bwd_kernels_match_plain_on_hopper_tiles(cuda, dtype, b, t, t_kv, h, d, causal, pad0):
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(a, device=cuda).to(dt) for a in _qkv(t, t_kv, seed=d + t, d=d, b=b, h=h))
    pad = None if pad0 is None else torch.tensor([pad0] + [0] * (b - 1), device=cuda)
    rng = np.random.default_rng(d + t + 1)
    do = torch.tensor(rng.standard_normal(q.shape).astype(np.float32), device=cuda).to(dt)
    scale = d ** -0.5
    o, lse = tattn.flash_attention(q, k, v, causal=causal, pad=pad, return_lse=True)
    dlse = torch.randn(lse.shape, device=cuda)
    delta = tattn._bwd_delta(o, do, dlse)
    before = (tattn.flash_bwd_dq.launches, tattn.flash_bwd_dkv.launches)
    dq = tattn.flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale, pad=pad)
    dk, dv = tattn.flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale, pad=pad)
    torch.cuda.synchronize()
    assert (tattn.flash_bwd_dq.launches, tattn.flash_bwd_dkv.launches) == (before[0] + 1, before[1] + 1)
    assert dq.dtype == dk.dtype == dv.dtype == dt
    want = tattn._flash_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale, pad=pad, dlse=dlse)
    errs = _row_errs((dq, dk, dv), want)
    assert max(errs) <= ROW_TOL[dt], errs


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_autograd_on_card(cuda, dtype):
    """Gradients through flash_attention (forward kernel + both backward
    kernels, with an LSE cotangent) against autograd through the plain
    forward; two runs give the same bits (no atomics)."""
    dt = getattr(torch, dtype)
    q, k, v, pad, do = _bwd_inputs(150, 150, 3, 64, dt, cuda, True)
    w = torch.randn((2, 3, 150), device=cuda)

    def grads(fn):
        args = [x.clone().requires_grad_() for x in (q, k, v)]
        o, lse = fn(*args)
        real = lse > tattn.NEG_INF / 2
        ((o.float() * do.float()).sum() + (torch.where(real, lse, 0 * lse) * w).sum()).backward()
        return [a.grad for a in args]

    kern = grads(lambda *a: tattn.flash_attention(*a, causal=True, pad=pad, return_lse=True))
    again = grads(lambda *a: tattn.flash_attention(*a, causal=True, pad=pad, return_lse=True))
    plain = grads(lambda *a: tattn._flash_attention_plain(*a, causal=True, scale=64 ** -0.5, pad=pad))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(kern, again))
    errs = _row_errs(kern, plain)
    assert max(errs) <= ROW_TOL[dt], errs


@pytest.mark.gpu
def test_flash_bwd_reads_strided_dout(cuda):
    """dO as a non-contiguous view: the same gradients as a contiguous copy."""
    q, k, v, _, do = _bwd_inputs(96, 96, 4, 64, torch.bfloat16, cuda, False)
    o, lse = tattn.flash_attention(q, k, v, causal=True, return_lse=True)
    wide = torch.zeros((*do.shape[:3], 128), device=cuda, dtype=do.dtype)
    wide[..., 32:96] = do
    view = wide[..., 32:96]
    assert not view.is_contiguous()
    a = tattn.flash_attention_bwd(q, k, v, o, lse, view, causal=True, scale=0.125)
    b = tattn.flash_attention_bwd(q, k, v, o, lse, do.contiguous(), causal=True, scale=0.125)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["d_head", "dtype", "lse_shape", "dout_dtype"])
def test_flash_bwd_raises_on_what_it_does_not_take(cuda, case):
    q, k, v, _, do = _bwd_inputs(8, 8, 0, 16, torch.float32, cuda, False)
    lse = torch.zeros((2, 3, 8), device=cuda)
    if case == "d_head":
        q, k, v, _, do = _bwd_inputs(8, 8, 0, 24, torch.float32, cuda, False)
    elif case == "dtype":
        q, k, v, do = q.half(), k.half(), v.half(), do.half()
    elif case == "lse_shape":
        lse = lse[:, :, :4]
    elif case == "dout_dtype":
        do = do.bfloat16()
    with pytest.raises(ValueError):
        tattn.flash_bwd_dq(q, k, v, do, lse, lse, causal=True, scale=0.25)
    with pytest.raises(ValueError):
        tattn.flash_bwd_dkv(q, k, v, do, lse, lse, causal=True, scale=0.25)


def _plain_bwd_case(t, t_kv, causal, padded, d):
    q, k, v, pad, do = _bwd_inputs(t, t_kv, d, d, torch.bfloat16, "cpu", padded)
    scale = d ** -0.5
    o, lse = tattn._flash_attention_plain(q, k, v, causal=causal, scale=scale, pad=pad)
    want = tattn._flash_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale, pad=pad)
    return (q, k, v, pad, do, o, lse, scale), want


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("t,t_kv,causal,padded", CASES + [FLAGSHIP_T])
def test_bf16_bwd_tolerance_rejects_mis_mapped_keys(d, t, t_kv, causal, padded):
    """On the card's bf16 inputs, a backward that reads V of key `key ^ 8`
    (the two halves of a 16-key mma step swapped) moves dQ far past the
    bf16 tolerance, and one that reads dO of query `row ^ 8` moves
    dK and dV; so the on-card comparison would reject such kernels."""
    (q, k, v, pad, do, o, lse, scale), want = _plain_bwd_case(t, t_kv, causal, padded, d)

    def swap(n):
        i = torch.arange(n)
        return torch.where((i ^ 8) < n, i ^ 8, i)

    ks, qs = swap(t_kv), swap(t)
    bad_dq = tattn._flash_bwd_plain(q, k, v[:, ks], o, lse, do, causal=causal, scale=scale,
                                    pad=pad)[0]
    bad_kv = tattn._flash_bwd_plain(q, k, v, o, lse, do[:, qs], causal=causal, scale=scale,
                                    pad=pad)[1:]
    tol = ROW_TOL[torch.bfloat16]
    assert _row_errs((bad_dq,), want[:1])[0] > 5 * tol
    assert min(_row_errs(bad_kv, want[1:])) > 5 * tol


@pytest.mark.parametrize("fault", ["skipped_tile", "unwritten_tile"])
@pytest.mark.parametrize("t,t_kv,causal,padded", CASES + [FLAGSHIP_T])
def test_bf16_bwd_tolerance_rejects_late_tile_faults(t, t_kv, causal, padded, fault):
    """Faults confined to one late 32-row tile, where the causal gradients
    are smallest: the dQ loop skipping one 32-key tile below the diagonal
    for the last 32 query rows (and the dK/dV loop skipping those rows for
    that key tile), or those rows left unwritten.  The row error reads each
    as O(1), far past the bf16 tolerance; at T 1024 an error relative to
    the largest element reads the unwritten dV tile at 0.024, about 1.2x
    the limit."""
    (q, k, v, pad, do, o, lse, scale), want = _plain_bwd_case(t, t_kv, causal, padded, 128)
    bad = _plant_tile_fault(q, k, v, pad, do, o, lse, scale, want, fault, n_rows=32, n_keys=32)
    assert min(_row_errs(bad, want)) > 5 * ROW_TOL[torch.bfloat16]


def _plant_tile_fault(q, k, v, pad, do, o, lse, scale, want, fault, n_rows, n_keys):
    """(dQ, dK, dV) of `want` with one tile lost: the last n_rows query rows
    against the n_keys keys that end n_rows before them, either skipped
    (their pairs' terms removed) or left unwritten (zeros)."""
    t, t_kv = q.shape[1], k.shape[1]
    rows, c0 = slice(t - n_rows, t), min(t, t_kv) - n_rows - n_keys
    keys = slice(c0, c0 + n_keys)
    bad = [w.float().clone() for w in want]
    if fault == "skipped_tile":
        # the pairs (rows, keys) are all live under causal: c0 + n_keys <= t - n_rows
        sub_pad = None if pad is None else (pad - c0).clamp(min=0)
        part = tattn._flash_bwd_plain(q[:, rows], k[:, keys], v[:, keys], o[:, rows],
                                      lse[:, :, rows], do[:, rows], causal=False, scale=scale,
                                      pad=sub_pad)
        bad[0][:, rows] -= part[0].float()
        bad[1][:, keys] -= part[1].float()
        bad[2][:, keys] -= part[2].float()
    else:
        bad[0][:, rows] = 0
        bad[1][:, keys] = 0
        bad[2][:, keys] = 0
    return bad


@pytest.mark.parametrize("fault", ["skipped_tile", "unwritten_tile"])
@pytest.mark.parametrize("t,t_kv,causal,padded", CASES[:2] + [FLAGSHIP_T])
def test_bf16_bwd_tolerance_rejects_lost_hopper_tiles(t, t_kv, causal, padded, fault):
    """The same faults at the Hopper kernels' tile shapes: a dK/dV block
    that skips one 64-row query tile against its 128 keys (and a dQ block
    that skips those 128 keys for the 64 rows of one consumer warpgroup),
    or those 64 rows and 128 keys left unwritten.  The row error reads
    each as O(1), far past the bf16 tolerance.  The shapes are those where
    64 late rows see 128 earlier keys in full under causal."""
    (q, k, v, pad, do, o, lse, scale), want = _plain_bwd_case(t, t_kv, causal, padded, 128)
    bad = _plant_tile_fault(q, k, v, pad, do, o, lse, scale, want, fault, n_rows=64, n_keys=128)
    assert min(_row_errs(bad, want)) > 5 * ROW_TOL[torch.bfloat16]


# ------------------------------------------------ forward at the Hopper tiles
#
# The bf16 forward at D 64 and 128 works on 128-row query blocks (64 rows a
# consumer warpgroup) and 64-key K/V tiles, skips the key tiles wholly
# below pad[b] and the query blocks that see no key.  Besides O's largest
# element error and LSE's, O is held row by row as the backward's gradients
# are (the row error above, limits ROW_TOL).
#
# (B, T, T_kv, H, D, causal, pad of batch row 0): a pad of 150 across the
# third 64-key tile; ragged 520-row and 520-key edges; a pad of 300 that
# covers two whole 128-row query blocks (causal: they see no key; not
# causal: they see the keys past the pad); T 60, where the block's second
# warpgroup has no rows while the first reads 9 key tiles; the flagship
# prefill cut to B 2, its shortest prompt (128 live tokens of 512) in row 0;
# and the flagship training step's attention, whose blocks run the steady
# loop over up to 16 mask-free tiles.
FWD_HOPPER_CASES = [
    (b, t, t_kv, h, d, causal, pad0)
    for b, t, t_kv, h, causal, pad0 in [(2, 333, 333, 3, True, 150), (2, 96, 520, 3, False, None),
                                        (2, 520, 96, 3, True, None), (2, 400, 400, 3, True, 300),
                                        (2, 400, 400, 3, False, 300), (2, 60, 520, 3, False, None)]
    for d in (64, 128)
] + [(2, 512, 512, 8, 128, True, 384), (8, 1024, 1024, 8, 128, True, None)]


def _fwd_errs(o, lse, po, plse):
    """(O's largest element error, LSE's on the rows that see a key,
    whether the fully masked rows hold LSE = -1e30 exactly, O's row
    error) of the forward (o, lse) against the plain version's."""
    real = plse > tattn.NEG_INF / 2
    err_o = (o.float() - po.float()).abs().max().item()
    err_lse = (lse - plse).abs()[real].max().item() if bool(real.any()) else 0.0
    masked = bool(torch.all(lse[~real] == tattn.NEG_INF))
    return err_o, err_lse, masked, _row_errs((o,), (po,))[0]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,t_kv,h,d,causal,pad0", FWD_HOPPER_CASES)
def test_flash_kernel_matches_plain_on_hopper_tiles(cuda, dtype, b, t, t_kv, h, d, causal, pad0):
    """Limits: O and LSE as in TOL, O's row error as in ROW_TOL, fully
    masked rows at LSE = -1e30 exactly; two calls give the same bits."""
    dt = getattr(torch, dtype)
    q, k, v = (torch.tensor(a, device=cuda).to(dt) for a in _qkv(t, t_kv, seed=d + t, d=d, b=b, h=h))
    pad = None if pad0 is None else torch.tensor([pad0] + [0] * (b - 1), device=cuda)
    before = tattn.flash_attention.launches
    o, lse = tattn.flash_attention(q, k, v, causal=causal, pad=pad, return_lse=True)
    o2, lse2 = tattn.flash_attention(q, k, v, causal=causal, pad=pad, return_lse=True)
    torch.cuda.synchronize()
    assert tattn.flash_attention.launches == before + 2
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    po, plse = tattn._flash_attention_plain(q, k, v, causal=causal, scale=d ** -0.5, pad=pad)
    err_o, err_lse, masked, row = _fwd_errs(o, lse, po, plse)
    tol_o, tol_lse = TOL[dt]
    assert err_o <= tol_o and err_lse <= tol_lse and masked and row <= ROW_TOL[dt], (
        err_o, err_lse, masked, row)


@pytest.mark.parametrize("fault", ["skipped_kv_tile", "unwritten_o_tile", "skipped_tile_above_pad"])
@pytest.mark.parametrize("t,t_kv,causal,padded", CASES + [FLAGSHIP_T])
def test_bf16_fwd_tolerance_rejects_lost_hopper_tiles(t, t_kv, causal, padded, fault):
    """Faults of the forward's tile geometry, planted in the plain
    version's O and LSE on the card's bf16 inputs: the last 64-row
    warpgroup skipping the 64-key tile that holds the key just before its
    first row; that warpgroup's 64 O rows left unwritten (zeros); batch row
    0 skipping the 64-key tile that holds pad[0] (the first tile it loads)
    as if it lay wholly below the pad.  The limits the card's check uses (O,
    LSE, masked rows, O's row error) reject each by more than 5x."""
    d = 128
    q, k, v = (torch.tensor(a).bfloat16() for a in _qkv(t, t_kv, seed=d, d=d))
    pad = _pad(t_kv, padded, "cpu")
    scale = d ** -0.5
    po, plse = tattn._flash_attention_plain(q, k, v, causal=causal, scale=scale, pad=pad)
    rb = (t - 1) // 64 * 64  # the last warpgroup's first row
    s = tattn._masked_scores(q, k, causal=causal, scale=scale, pad=pad)
    if fault == "skipped_kv_tile":
        kt0 = max(0, (min(rb, t_kv) - 1) // 64 * 64)
        s[:, :, rb:, kt0:kt0 + 64] = tattn.NEG_INF
        bad_o, bad_lse = tattn._plain_from_scores(s, v, q.dtype)
    elif fault == "unwritten_o_tile":
        bad_o, bad_lse = po.clone(), plse
        bad_o[:, rb:rb + 64] = 0
    else:
        kt0 = (0 if pad is None else int(pad[0])) // 64 * 64
        s[0, :, :, kt0:kt0 + 64] = tattn.NEG_INF
        bad_o, bad_lse = tattn._plain_from_scores(s, v, q.dtype)
    err_o, err_lse, masked, row = _fwd_errs(bad_o, bad_lse, po, plse)
    tol_o, tol_lse = TOL[torch.bfloat16]
    assert not masked or max(err_o / tol_o, err_lse / tol_lse, row / ROW_TOL[torch.bfloat16]) > 5, (
        err_o, err_lse, masked, row)
