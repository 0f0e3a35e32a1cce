"""The decode-attention CUDA kernel (cluster_anywhere_tpu_torch/ops/csrc/
decode_attention.cu) against its plain PyTorch version, on the card, and
what surrounds it on the CPU: the plain version against a direct softmax
over each row's live columns, the checks the wrapper makes, and the
batcher's empty range for a free slot.  The tests marked `gpu` skip without
a GPU (the kernel has no CPU mode).  This file imports no JAX, so it runs
where only the port is installed:

    python -m pytest tests/test_torch_decode_kernel.py -q -m gpu
"""

import importlib

import numpy as np
import pytest
import torch

tattn = importlib.import_module("cluster_anywhere_tpu_torch.ops.attention")
tcont = importlib.import_module("cluster_anywhere_tpu_torch.llm.continuous")
tgen = importlib.import_module("cluster_anywhere_tpu_torch.models.generate")
ttf = importlib.import_module("cluster_anywhere_tpu_torch.models.transformer")

# Each output row (one query head of one cache row, D values) is held to its
# own norm, ||got - want|| / max(||want||, 0.1 * RMS over rows of ||want||).
# fp32 1e-4: full fp32 in both, the kernel's 2^x approximate (2^-22
# relative) and its sums in another order.  bf16 2e-2: both outputs are
# rounded to bf16 (2^-8 relative), and the plain version rounds P to bf16
# before P.V where the kernel keeps it in fp32; a key mapped to the wrong
# V row or a column off the range moves a row by O(1) (the unmarked tests).
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
Q_GAIN = 3.0  # scores of standard deviation 3: each softmax row is peaked
T_MAX = 600  # three chunks of the kernel's 256 columns, the last one partial
# (start, end) a row: every column; one key at T_max - 1 (pos at the cache's
# end); one key; across two chunk boundaries; a free slot's empty range; a
# range ending on a chunk boundary
RANGES = [(0, T_MAX), (T_MAX - 1, T_MAX), (10, 11), (250, 520), (300, 300), (37, 256)]


def _inputs(b, t_max, h, kv, d, seed, dt, device):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, h, d)) * Q_GAIN
    k, v = (rng.standard_normal((b, t_max, kv, d)) for _ in range(2))
    return tuple(torch.tensor(a, dtype=torch.float32, device=device).to(dt) for a in (q, k, v))


def _range_tensors(ranges, device):
    start, end = zip(*ranges)
    return torch.tensor(start, device=device), torch.tensor(end, device=device)


def _row_err(got, want):
    diff, norm = (got.float() - want.float()).norm(dim=-1), want.float().norm(dim=-1)
    floor = 0.1 * norm.square().mean().sqrt()
    return (diff / norm.clamp(min=floor.item())).max().item()


def _direct(q, k, v, start, end):
    """Softmax over each row's live columns alone, in fp64: the function
    both versions compute, written the obvious way."""
    b, _, h, d = q.shape
    g = h // k.shape[2]
    out = torch.zeros(b, 1, h, d, dtype=torch.float64)
    for r in range(b):
        s0, e0 = int(start[r]), int(end[r])
        for hh in range(h):
            kk, vv = k[r, s0:e0, hh // g].double(), v[r, s0:e0, hh // g].double()
            p = torch.softmax(kk @ q[r, 0, hh].double() * d ** -0.5, dim=0)
            out[r, 0, hh] = p @ vv
    return out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# ------------------------------------------------------------------ the card


def _check_on_card(cuda, dt, b, t_max, h, kv, d, ranges, seed):
    q, k, v = _inputs(b, t_max, h, kv, d, seed, dt, cuda)
    start, end = _range_tensors(ranges, cuda)
    before = tattn.decode_attention.launches
    o = tattn.decode_attention(q, k, v, start, end)
    torch.cuda.synchronize()
    assert tattn.decode_attention.launches == before + 1
    assert o.shape == q.shape and o.dtype == dt
    want = tattn._decode_attention_plain(q, k, v, start, end, d ** -0.5)
    live = [r for r, (s0, e0) in enumerate(ranges) if e0 > s0]
    err = _row_err(o[live], want[live])
    assert err <= ROW_TOL[dt], f"row error {err}"
    empty = [r for r in range(b) if r not in live]
    assert torch.all(o[empty] == 0)
    return o


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("h,kv", [(8, 8), (8, 2)])
def test_decode_kernel_matches_plain_on_card(cuda, dtype, d, h, kv):
    """Every D the flash kernels take, both dtypes, MHA and a GQA group of 4,
    over the ragged RANGES."""
    _check_on_card(cuda, getattr(torch, dtype), len(RANGES), T_MAX, h, kv, d, RANGES,
                   seed=d + h // kv)


@pytest.mark.gpu
@pytest.mark.parametrize("h,kv", [(4, 2), (6, 2), (16, 2), (32, 2)])
def test_decode_kernel_head_groups_on_card(cuda, h, kv):
    """Groups of 2, 3 (heads a block 1), 8, and 16 (two blocks share a KV
    head)."""
    _check_on_card(cuda, torch.bfloat16, len(RANGES), T_MAX, h, kv, 64, RANGES, seed=h)


@pytest.mark.gpu
def test_decode_kernel_at_the_chat_cells_shape(cuda):
    """32 slots, T_max 2560, 32 heads of 128, bf16: prompts left-padded into
    a 2048 bucket (lengths lognormal about 512, 32-2048) with 1-512 tokens
    generated, a free slot, a row over every column and one at the cache's
    last column."""
    rng = np.random.default_rng(7)
    plen = np.clip(rng.lognormal(np.log(512), 0.8, 32), 32, 2048).astype(int)
    gen = rng.integers(1, 513, 32)
    ranges = [(2048 - int(p), 2048 + int(g)) for p, g in zip(plen, gen)]
    ranges[3] = (2100, 2100)
    ranges[5] = (0, 2560)
    ranges[9] = (2048 - int(plen[9]), 2560)
    _check_on_card(cuda, torch.bfloat16, 32, 2560, 32, 32, 128, ranges, seed=1)


@pytest.mark.gpu
def test_free_lane_does_not_disturb_other_rows_on_card(cuda):
    """A row's output does not depend on another row's range: the same bits
    whether row 4 is free or reads every column."""
    q, k, v = _inputs(len(RANGES), T_MAX, 8, 2, 128, 3, torch.bfloat16, cuda)
    start, end = _range_tensors(RANGES, cuda)
    o_free = tattn.decode_attention(q, k, v, start, end)
    start[4], end[4] = 0, T_MAX
    o_full = tattn.decode_attention(q, k, v, start, end)
    torch.cuda.synchronize()
    others = [r for r in range(len(RANGES)) if r != 4]
    assert torch.equal(o_free[others], o_full[others])
    assert torch.all(o_free[4] == 0) and not torch.all(o_full[4] == 0)


@pytest.mark.gpu
def test_decode_kernel_reads_cache_views_in_place(cuda):
    """One layer of a stacked [L, B, T_max, KV, D] cache and a strided q: the
    kernel reads them through their strides, the same bits as copies."""
    caches = torch.randn(2, 2, len(RANGES), T_MAX, 2, 64, device=cuda).bfloat16()
    k, v = caches[0, 1], caches[1, 1]
    fused = torch.randn(len(RANGES), 1, 8, 3 * 64, device=cuda).bfloat16()
    q = fused[..., 64:128]
    assert not q.is_contiguous()
    start, end = _range_tensors(RANGES, cuda)
    o = tattn.decode_attention(q, k, v, start, end)
    ref = tattn.decode_attention(q.contiguous(), k.clone(), v.clone(), start, end)
    torch.cuda.synchronize()
    assert torch.equal(o, ref)


@pytest.mark.gpu
def test_decode_kernel_raises_on_what_it_does_not_take(cuda):
    start, end = _range_tensors(RANGES, cuda)
    q, k, v = _inputs(len(RANGES), T_MAX, 4, 4, 24, 0, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        tattn.decode_attention(q, k, v, start, end)
    q, k, v = _inputs(len(RANGES), T_MAX, 4, 4, 64, 0, torch.float16, cuda)
    with pytest.raises(ValueError):
        tattn.decode_attention(q, k, v, start, end)


@pytest.mark.gpu
def test_decode_launches_one_kernel_a_layer_a_step(cuda):
    """decode_one and the batcher's row-position step each launch the decode
    kernel once a layer a step, and never the flash forward."""
    cfg = ttf.TransformerConfig(vocab_size=64, d_model=64, n_layers=3, n_heads=4, n_kv_heads=2,
                                d_head=16, d_ff=128, dtype="bfloat16")
    model = ttf.init_params(cfg, 0, device=cuda)
    b, t, steps = 3, 16, 4
    ids = torch.randint(0, cfg.vocab_size, (b, t), device=cuda)
    pad = torch.tensor([0, 5, 9], device=cuda)
    with torch.no_grad():
        _, cache = tgen.prefill(model, ids, cfg, t + 2 * steps, pad=pad)
        fwd0, dec0 = tattn.flash_attention.launches, tattn.decode_attention.launches
        tok = ids[:, -1]
        for i in range(steps):
            tgen.decode_one(model, cache, tok, t + i, cfg, pad)
        pos = torch.full((b,), t + steps, device=cuda)
        knobs = (torch.zeros(b, device=cuda), torch.zeros(b, dtype=torch.long, device=cuda),
                 torch.ones(b, device=cuda))
        gen = torch.Generator(device=cuda).manual_seed(0)
        for i in range(steps):
            tok, cache = tcont._decode_step_rowpos(model, cache, tok.long(), pos + i, pad, *knobs,
                                                   gen, cfg=cfg)
        torch.cuda.synchronize()
    assert tattn.decode_attention.launches - dec0 == 2 * steps * cfg.n_layers
    assert tattn.flash_attention.launches == fwd0


# ------------------------------------------------------------------ the CPU


@pytest.mark.parametrize("h,kv", [(4, 4), (4, 1), (6, 2)])
def test_plain_decode_is_softmax_over_the_live_columns(h, kv):
    """The plain version (the CPU path, and the kernel's yardstick) is the
    softmax over columns [start, end) alone, query head h on KV head
    h // (H / KV)."""
    q, k, v = _inputs(len(RANGES), T_MAX, h, kv, 16, 5, torch.float32, "cpu")
    start, end = _range_tensors(RANGES, "cpu")
    got = tattn._decode_attention_plain(q, k, v, start, end, 16 ** -0.5)
    want = _direct(q, k, v, start, end)
    live = [r for r, (s0, e0) in enumerate(RANGES) if e0 > s0]
    torch.testing.assert_close(got[live].double(), want[live], atol=1e-5, rtol=0)


def test_decode_attention_runs_the_plain_version_on_cpu():
    q, k, v = _inputs(len(RANGES), T_MAX, 4, 2, 32, 6, torch.bfloat16, "cpu")
    start, end = _range_tensors(RANGES, "cpu")
    before = tattn.decode_attention.launches
    got = tattn.decode_attention(q, k, v, start, end)
    assert torch.equal(got, tattn._decode_attention_plain(q, k, v, start, end, 32 ** -0.5))
    assert tattn.decode_attention.launches == before


@pytest.mark.parametrize("fault", ["range_left", "range_right", "v_key_xor_1", "head_mod"])
def test_bf16_tolerance_rejects_a_wrong_kernel(fault):
    """On the card's bf16 inputs, a kernel whose range is off by one column
    (seen on the one-key rows, where it swaps the key), maps a key to its
    neighbour's V row, or maps query head h to KV head h % KV in place of
    h // (H / KV) moves every row it reaches far past the bf16 limit."""
    h, kv, d = 8, 2, 128
    q, k, v = _inputs(len(RANGES), T_MAX, h, kv, d, 8, torch.bfloat16, "cpu")
    start, end = _range_tensors(RANGES, "cpu")
    rows = [r for r, (s0, e0) in enumerate(RANGES) if e0 > s0]
    good = tattn._decode_attention_plain(q, k, v, start, end, d ** -0.5)
    if fault in ("range_left", "range_right"):
        shift = -1 if fault == "range_left" else 1
        rows = [r for r in rows if RANGES[r][1] - RANGES[r][0] == 1
                and 0 <= RANGES[r][0] + shift and RANGES[r][1] + shift <= T_MAX]
        bad = tattn._decode_attention_plain(q, k, v, start + shift, end + shift, d ** -0.5)
    elif fault == "v_key_xor_1":
        keys = torch.arange(T_MAX)
        bad = tattn._decode_attention_plain(q, k, v[:, keys ^ 1], start, end, d ** -0.5)
    else:
        heads = torch.arange(h) % kv
        bad = tattn._decode_attention_plain(q, k[:, :, heads], v[:, :, heads], start, end,
                                            d ** -0.5)
    assert rows
    errs = [_row_err(bad[r:r + 1], good[r:r + 1]) for r in rows]
    assert min(errs) > 10 * ROW_TOL[torch.bfloat16], errs


@pytest.mark.parametrize("what", ["d_head", "dtype", "one_token", "heads", "range_dtype",
                                  "d_stride", "row_align"])
def test_check_decode_inputs_refuses(what):
    q, k, v = _inputs(2, 64, 4, 2, 64, 0, torch.bfloat16, "cpu")
    start, end = torch.tensor([0, 3]), torch.tensor([10, 64])
    if what == "d_head":
        q, k, v = (x[..., :24].contiguous() for x in (q, k, v))
    elif what == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif what == "one_token":
        q = q.expand(2, 2, 4, 64)
    elif what == "heads":
        q = torch.cat([q, q[:, :, :1]], dim=2)  # 5 query heads over 2 KV heads
    elif what == "range_dtype":
        end = end.float()
    elif what == "d_stride":
        k = k.transpose(1, 3).contiguous().transpose(1, 3)  # unit stride on T_max, not D
    else:
        k = torch.zeros(2 * 64 * 2 * 64 + 1, dtype=torch.bfloat16)[1:].view(2, 64, 2, 64)
    with pytest.raises(ValueError):
        tattn.check_decode_inputs(q, k, v, start, end)
    tattn.check_decode_inputs(*_inputs(2, 64, 4, 2, 64, 0, torch.bfloat16, "cpu"),
                              torch.tensor([0, 3]), torch.tensor([10, 64]))


def _tiny_batcher(slots):
    cfg = ttf.TransformerConfig(vocab_size=64, d_model=32, n_layers=2, n_heads=4, n_kv_heads=2,
                                d_head=8, d_ff=64, dtype="float32")
    return tcont.ContinuousBatcher(ttf.init_params(cfg, 0, device="cpu"), cfg, slots=slots,
                                   t_max=64, prefill_buckets=(8, 16))


def test_batcher_hands_free_slots_an_empty_range(monkeypatch):
    """A free slot's lane attends over [pos + 1, pos + 1); a live slot keeps
    its pad; the batcher's own pads are left as they were."""
    cb = _tiny_batcher(3)
    seen = []
    orig = tcont._decode_step_rowpos

    def spy(params, cache, tokens, pos, pads, *a, **k):
        seen.append((pos.clone(), pads.clone(), cb._pads.copy()))
        return orig(params, cache, tokens, pos, pads, *a, **k)

    monkeypatch.setattr(tcont, "_decode_step_rowpos", spy)
    req = cb.submit(np.arange(1, 6), max_new_tokens=4)
    cb.pump()
    assert req.done and len(req.out_tokens) == 4
    assert seen
    for pos, pads, own in seen:
        assert pads[req.slot] == own[req.slot] == 8 - 5  # the prompt's left pad in bucket 8
        free = [s for s in range(3) if s != req.slot]
        assert torch.equal(pads[free], pos[free] + 1)
        assert np.array_equal(own[free], np.zeros(2))


def test_batcher_tokens_unchanged_by_the_free_slots_range(monkeypatch):
    """Live requests' tokens with the free slots' empty range are those the
    batcher gave when free lanes attended from their stale pads."""
    prompts = [np.arange(1, 6), np.arange(7, 20), np.arange(3, 9)]

    def drive(cb):
        reqs = [cb.submit(p, max_new_tokens=n) for p, n in zip(prompts, (6, 3, 9))]
        cb.pump()
        return [r.out_tokens for r in reqs]

    got = drive(_tiny_batcher(4))
    monkeypatch.setattr(tcont.ContinuousBatcher, "_step_pads", lambda self: self._pads)
    assert got == drive(_tiny_batcher(4))
