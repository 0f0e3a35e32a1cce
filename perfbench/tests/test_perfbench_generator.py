"""The traffic generator: repeatable by seed, the same set of sizes and gaps
for every seed, and the distributions the mixes state."""

import numpy as np
import pytest
import torch

from perfbench import generator, manifest

BIG_SEED = 2**31 + 977  # the driver's seeds exceed 32 signed bits


def chat():
    return manifest.traffic("chat")


def test_open_loop_repeats_by_seed():
    a = generator.open_loop(chat(), 50, BIG_SEED, 102400)
    b = generator.open_loop(chat(), 50, BIG_SEED, 102400)
    assert a == b
    c = generator.open_loop(chat(), 50, BIG_SEED + 1, 102400)
    assert [r["prompt"] for r in a] != [r["prompt"] for r in c]


def test_every_seed_gets_the_same_requests_at_the_same_moments():
    runs = [generator.open_loop(chat(), 50, s, 102400) for s in (1, 2, BIG_SEED)]
    for key in ("due_s", "max_new_tokens"):
        assert [r[key] for r in runs[0]] == [r[key] for r in runs[1]] == [r[key] for r in runs[2]]
    lens = [[len(r["prompt"]) for r in run] for run in runs]
    assert lens[0] == lens[1] == lens[2]
    assert runs[0][0]["prompt"] != runs[1][0]["prompt"]


def test_chat_distributions_as_stated():
    mix = chat()
    reqs = generator.open_loop(mix, 2000, 5, 102400)
    rate = mix["arrivals"]["rate_per_s"]
    assert len(reqs) == round(rate * 2000)
    due = [r["due_s"] for r in reqs]
    assert due[0] == 0.0 and all(b >= a for a, b in zip(due, due[1:])) and due[-1] < 2000
    gaps = np.diff(due)
    assert gaps.mean() == pytest.approx(1 / rate, rel=0.08)
    assert gaps.std() / gaps.mean() == pytest.approx(1.0, rel=0.1)  # exponential: cv 1
    p = np.array([len(r["prompt"]) for r in reqs])
    o = np.array([r["max_new_tokens"] for r in reqs])
    assert p.min() >= 32 and p.max() <= 2048 and o.min() >= 16 and o.max() <= 512
    assert np.median(p) == pytest.approx(512, rel=0.08)
    assert np.median(o) == pytest.approx(128, rel=0.08)
    assert np.log(p[(p > 32) & (p < 2048)]).std() == pytest.approx(0.8, rel=0.15)
    ids = np.concatenate([r["prompt"] for r in reqs[:50]])
    assert ids.min() >= 0 and ids.max() < 102400


def test_window_holds_every_due_time():
    for seconds in (5, 50):
        for seed in (3, BIG_SEED):
            reqs = generator.open_loop(chat(), seconds, seed, 100)
            assert max(r["due_s"] for r in reqs) < seconds


def test_uniform_lengths_cover_their_range():
    v = generator.draw({"dist": "uniform", "min": 512, "max": 1536}, 20000, np.random.default_rng(0))
    assert v.min() == 512 and v.max() == 1536 and abs(v.mean() - 1024) < 10


def test_gamma_arrivals_are_burstier():
    mix = chat()
    mix["arrivals"] = {"process": "gamma", "rate_per_s": 2.0, "cv": 3.0}
    gaps = np.diff([r["due_s"] for r in generator.open_loop(mix, 5000, 1, 10)])
    assert gaps.std() / gaps.mean() > 2.0


def test_train_batches_repeat_and_differ_by_step():
    mix = {"batch": 2, "seq_len": 16}
    a = generator.train_batch(mix, BIG_SEED, 1, 1000, "cpu")
    assert a.shape == (2, 17) and a.dtype == torch.int64
    assert torch.equal(a, generator.train_batch(mix, BIG_SEED, 1, 1000, "cpu"))
    assert not torch.equal(a, generator.train_batch(mix, BIG_SEED, 2, 1000, "cpu"))
    assert not torch.equal(a[0], a[1])


def test_tail_mean():
    from perfbench import harness

    assert harness.tail_mean(list(range(1, 101)), 0.1) == pytest.approx(95.5)
    assert harness.tail_mean([3.0], 0.1) == 3.0


def test_derive_takes_large_seeds():
    assert generator.derive(2**40, "x") != generator.derive(2**40 + 1, "x")
    assert 0 <= generator.derive(2**40, "x") < 2**63
