"""Both drivers end to end on the CPU at a tiny size: a sound run is
correct, and a run with the timed path broken underneath is not, once for
each fault the cell can have."""

import time

import pytest
import torch

import cluster_anywhere_tpu_torch.llm.continuous as continuous
import cluster_anywhere_tpu_torch.models.transformer as transformer
from perfbench import manifest
from perfbench.tests.tiny_cells import tiny_cell

SEED = 2**31 + 4242
CPU = torch.device("cpu")


def run(workload, seconds=2.0):
    cell = tiny_cell(workload)
    drv = manifest.driver(cell["traffic"]["kind"])
    return drv.run(cell, seed=SEED, seconds=seconds, trace=False, device=CPU, t_start=time.time())


def test_serving_sound_run_is_correct():
    res = run("dsllm7b.chat")
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["e2e"]) >= {"itl_tail10_mean_ms", "output_tok_s", "setup_s"}


def test_serving_token_altered_where_produced(monkeypatch):
    orig = continuous._decode_step_rowpos

    def altered(*a, **k):
        nxt, cache = orig(*a, **k)
        return (nxt + 1) % a[0].cfg.vocab_size, cache

    monkeypatch.setattr(continuous, "_decode_step_rowpos", altered)
    res = run("dsllm7b.chat")
    assert not res["correct"] and not res["checks"]["logit_gap"]["pass"]


def test_serving_step_leaves_its_cache_unchanged(monkeypatch):
    orig = continuous._block_decode_rowpos

    def stale(bp, x, layer_cache, pos, cfg, pads):
        return orig(bp, x, tuple(c.clone() for c in layer_cache), pos, cfg, pads)

    monkeypatch.setattr(continuous, "_block_decode_rowpos", stale)
    res = run("dsllm7b.chat")
    assert not res["correct"] and not res["checks"]["logit_gap"]["pass"]


def test_training_sound_run_is_correct():
    res = run("dsllm7b-stage8.train", seconds=1.0)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["e2e"]["train_tok_s"] > 0


def test_training_step_returns_its_state_unchanged(monkeypatch):
    orig = transformer.make_train_step

    def frozen(*a, **k):
        step, init_state = orig(*a, **k)
        loss_fn = transformer.make_loss_fn(a[0])

        def unchanged(model, opt, batch):
            return model, opt, loss_fn(model, batch).detach()

        return unchanged, init_state

    monkeypatch.setattr(transformer, "make_train_step", frozen)
    res = run("dsllm7b-stage8.train", seconds=1.0)
    assert not res["correct"]
    assert res["checks"]["change_norm_gap"]["value"] == pytest.approx(1.0)


def test_training_half_the_batch_left_out(monkeypatch):
    orig = transformer.cross_entropy_loss

    def half(logits, targets, mask=None):
        n = logits.shape[0] // 2
        return orig(logits[:n], targets[:n])

    monkeypatch.setattr(transformer, "cross_entropy_loss", half)
    res = run("dsllm7b-stage8.train", seconds=1.0)
    assert not res["correct"]
    assert not res["checks"]["grad_norm_gap"]["pass"]
