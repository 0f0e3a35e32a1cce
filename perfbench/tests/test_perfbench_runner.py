"""The runner refuses to run without a card, and prints no result."""

import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_exits_nonzero_without_a_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "-m", "perfbench.run", "--workload", "dsllm7b.chat",
                        "--seed", str(2**31 + 5), "--seconds", "5", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    import perfbench.run as run

    monkeypatch.setitem(sys.modules, "cluster_anywhere_tpu_torch_fake", sys)
    assert "cluster_anywhere_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib.fake" in run.forbidden_modules()
