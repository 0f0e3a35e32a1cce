"""On the card: both drivers at a tiny fp32 width run the port's flash
kernels once a layer for each prefill and training step, and their runs
are correct.  Skipped without a card (decided inside each test).  Run on
the card with `python -m pytest perfbench/tests -m gpu -q`."""

import time

import pytest
import torch

from perfbench import manifest
from perfbench.tests.tiny_cells import tiny_cell


def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["dsllm7b.chat", "dsllm7b-stage8.train"])
def test_tiny_cell_on_the_card(workload):
    dev = cuda()
    cell = tiny_cell(workload)
    if workload == "dsllm7b.chat":  # enough requests that the pump never idles
        cell["traffic"]["arrivals"]["rate_per_s"] = 40
    res = manifest.driver(cell["traffic"]["kind"]).run(
        cell, seed=2**31 + 99, seconds=2.0, trace=True, device=dev, t_start=time.time())
    assert res["correct"], res["checks"]
    launch_checks = [k for k in res["checks"] if "launches" in k]
    assert launch_checks and all(res["checks"][k]["pass"] for k in launch_checks)
    assert 0 < res["trace"]["busy_s"] <= res["trace"]["window_s"]
