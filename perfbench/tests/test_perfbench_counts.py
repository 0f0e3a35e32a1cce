"""The operation and byte counts against hand counts at small shapes."""

import pytest

from perfbench import counts

M = dict(vocab=10, d_model=4, n_layers=2, n_heads=2, n_kv_heads=1, d_head=2, d_ff=6)


def test_block_and_model_params():
    # q 4x4, k 4x2, v 4x2, o 4x4, gate/up 4x6 each, down 6x4
    assert counts.block_matmul_params(M) == 16 + 8 + 8 + 16 + 24 + 24 + 24
    # embed 40 + head 40 + 2 blocks (120 + 2 norms of 4) + final norm 4
    assert counts.n_params(M) == 40 + 40 + 2 * (120 + 8) + 4


def test_model_flops_per_step_by_hand():
    b, t = 1, 3
    per_tok = 2 * 120 * 2          # two layers' products, 2 FLOPs a multiply-add
    attn = 4 * t * t * 2 * 2 * 2 * 0.5  # 4 t^2 d h a layer, halved causally, 2 layers
    head = t * 2 * 4 * 10
    assert counts.model_flops_per_step(M, b, t) == 3 * (t * per_tok + attn + head)
    assert counts.model_flops_per_step(M, b, t, causal_discount=False) == \
        3 * (t * per_tok + 2 * attn + head)


def test_prefill_flops_by_hand():
    n = 3  # causal pairs 6
    assert counts.prefill_flops(M, n) == 3 * 2 * 2 * 120 + 2 * 4 * 2 * 2 * 6 + 2 * 4 * 10


def test_decode_step_flops_by_hand():
    # 3 live rows: 2 layers x 2 x 120 products and the head 2 x 4 x 10 each;
    # attention 2 layers x 4 x d 2 x h 2 over 50 keys
    assert counts.decode_step_flops(M, live=3, kv_tokens=50) == 3 * (480 + 80) + 2 * 16 * 50


def test_decode_step_bytes_by_hand():
    # weights: 2 x (120 + 8) + 4 + 40 = 300; 3 live rows of E = 12; K/V a token
    # over the layers 2 x 2 x 1 x 2 = 8: 50 tokens read, 3 written
    assert counts.decode_step_bytes(M, live=3, kv_tokens=50, elt=2) == 2 * (300 + 12 + 400 + 24)


def test_flash_fwd_cost_by_hand():
    flops, nbytes = counts.flash_fwd_cost(h=2, d=4, lens=[3, 1], elt=2)
    assert flops == 2 * 2 * 4 * 2 * (6 + 1)
    assert nbytes == 4 * (3 + 1) * 2 * 4 * 2
    _, with_lse = counts.flash_fwd_cost(h=2, d=4, lens=[3], elt=2, with_lse=True)
    assert with_lse == 4 * 3 * 2 * 4 * 2 + 3 * 2 * 4


def test_flash_bwd_costs_by_hand():
    c = counts.flash_bwd_costs(b=1, t=2, h=1, d=4, elt=2)
    pairs = 3
    row, stats = 2 * 4 * 2, 2 * 4
    assert c["dq"] == (3 * 2 * 4 * pairs, 5 * row + 2 * stats)
    assert c["dkv"] == (4 * 2 * 4 * pairs, 6 * row + 2 * stats)


def test_bound_ms_takes_the_longer():
    ms, by = counts.bound_ms(3.35e9, 1.0)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = counts.bound_ms(1.0, 989e9)
    assert ms == pytest.approx(1.0) and by == "operations"
