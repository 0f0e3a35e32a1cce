"""The trace reduction and the per-layer readers on a made-up trace."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from perfbench import counts, manifest, profiling


def ev(name, start, end, device=DeviceType.CUDA):
    return SimpleNamespace(name=name, device_type=device, is_user_annotation=False,
                           time_range=SimpleNamespace(start=start, end=end))


def events():
    cpu = DeviceType.CPU
    return [
        ev("perfbench.step", 0, 100, cpu), ev("perfbench.admit", 0, 40, cpu),
        ev("aten::mm", 1, 5, cpu), ev("aten::item", 32, 44, cpu),
        ev("flash_fwd_bf16_wgmma<128>", 2, 12), ev("gemm", 10, 30),   # admit, overlapping
        ev("gemm", 45, 70), ev("elementwise", 80, 90),                # decode
    ]


def test_reduce_busy_gaps_and_phases():
    s = profiling.reduce(events(), window_s=100e-6)
    assert s["busy_s"] == pytest.approx((30 - 2 + 25 + 10) / 1e6)
    assert s["gaps"] == [(30, 45), (70, 80)]
    phases = {(n, st): p for n, st, _, p in s["kernels"]}
    assert phases[("flash_fwd_bf16_wgmma<128>", 2)] == "admit"
    assert phases[("gemm", 45)] == "step"
    assert profiling.phase_ms(s, "admit") == pytest.approx((10 + 20) / 1e3)
    assert profiling.kernel_ms(s, ("flash_fwd",), phase="admit") == pytest.approx(0.01)
    b = profiling.breakdown(s)
    assert b["device_ops"][0] == ["gemm", pytest.approx(45e-6)]
    assert dict(b["idle_gaps"]) == {"aten::item": pytest.approx(15e-6),
                                     "no host op recorded": pytest.approx(10e-6)}


def test_readers_on_a_made_up_serving_trace():
    m = manifest.model_dims(manifest.read_json("perfbench/configs/deepseek-llm-7b.json"))
    s = profiling.reduce(events(), window_s=100e-6)
    ctx = {"dims": m, "trace": s, "seconds": 1,
           "admissions": [{"ms": 60.0, "k": 1, "lens": [500], "profiled": True},
                          {"ms": 80.0, "k": 2, "lens": [100, 200], "profiled": False}],
           "decodes": [{"live": 3, "kv_tokens": 900, "profiled": True}]}
    assert manifest.reader("admit_ms.chat")(ctx) == pytest.approx((60 + 160) / 3)
    want = counts.decode_step_bytes(m, 3, 900) / (35e-6) / counts.HBM_BYTES_S * 100
    assert manifest.reader("decode_mbu.chat")(ctx) == pytest.approx(want)
    want = counts.prefill_flops(m, 500) / 30e-6 / counts.BF16_FLOPS * 100
    assert manifest.reader("prefill_mfu.chat")(ctx) == pytest.approx(want)
    flops, nbytes = counts.flash_fwd_cost(32, 128, [500])
    want = 30 * counts.bound_ms(nbytes, flops)[0] / 0.01 * 100
    assert manifest.reader("flash_fwd_roofline.chat")(ctx) == pytest.approx(want)
    assert manifest.reader("device_idle_pct.chat")(ctx) == pytest.approx(37.0)
    want = (counts.prefill_flops(m, 500) + counts.decode_step_flops(m, 3, 900)) / 100e-6
    assert manifest.reader("step_mfu.chat")(ctx) == pytest.approx(want / counts.BF16_FLOPS * 100)


def test_readers_find_nothing_and_say_so():
    empty = {"dims": {}, "trace": None, "admissions": [], "decodes": []}
    for name in ("admit_ms.chat", "decode_mbu.chat", "prefill_mfu.chat", "step_mfu.chat",
                 "flash_fwd_roofline.chat", "device_idle_pct.chat", "flash_fwd_roofline.train",
                 "flash_bwd_roofline.train", "optimizer_ms.train", "device_idle_pct.train",
                 "mfu.train"):
        assert manifest.reader(name)(empty) is None, name


def test_training_readers_on_a_made_up_trace():
    m = manifest.model_dims(manifest.read_json("perfbench/configs/deepseek-llm-7b-stage8.json"))
    mix = manifest.traffic("pretrain_4k")
    kern = [ev("flash_fwd_bf16_wgmma<128>", 0, 100), ev("bwd_dq_bf16_wgmma<128>", 100, 300),
            ev("bwd_dkv_bf16_wgmma<128>", 300, 600), ev("multi_tensor_apply_kernel", 700, 900)]
    s = profiling.reduce(kern, window_s=1000e-6)
    ctx = {"dims": m, "mix": mix, "trace": s, "profiled_steps": 1, "window_steps": 10,
           "window_s": 4.0}
    flops, nbytes = counts.flash_fwd_cost(32, 128, [4096] * mix["batch"], with_lse=True)
    assert manifest.reader("flash_fwd_roofline.train")(ctx) == pytest.approx(
        8 * counts.bound_ms(nbytes, flops)[0] / 0.1 * 100)
    assert manifest.reader("optimizer_ms.train")(ctx) == pytest.approx(0.2)
    assert manifest.reader("device_idle_pct.train")(ctx) == pytest.approx(20.0)
    mfu = counts.model_flops_per_step(m, mix["batch"], 4096) * 10 / 4.0 / counts.BF16_FLOPS * 100
    assert manifest.reader("mfu.train")(ctx) == pytest.approx(mfu)
    assert manifest.reader("flash_bwd_roofline.train")(ctx) > 0
