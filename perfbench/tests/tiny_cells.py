"""A cell of BENCHMARK.json shrunk to a CPU test's size: the same files and
drivers, a tiny width, depth, vocabulary and traffic, fp32 throughout (the
port's CPU path has no bf16 kernels to hold to)."""

import copy

from perfbench import manifest

TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
            intermediate_size=128, vocab_size=512)


def tiny_cell(workload: str) -> dict:
    cell = copy.deepcopy(manifest.cell(manifest.load(), workload))
    cfg = cell["config"]
    cfg.update(TINY)
    cfg["precision"] = {"params": "float32", "activations": "float32"}
    mix = cell["traffic"]
    if mix["kind"] == "serve_open_loop":
        # fp32 on both sides: a served token's gap is round-off, ~1e-6
        cfg["limits"] = {"serve": {"logit_gap": 1e-3, "served_tokens": 60, "max_requests": 6}}
        mix["engine"].update(slots=4, max_prompt_len=64, max_new_tokens=16)
        mix["arrivals"] = {"process": "poisson", "rate_per_s": 4}
        mix["prompt_tokens"] = {"dist": "lognormal", "median": 20, "sigma": 0.8, "min": 4, "max": 64}
        mix["output_tokens"] = {"dist": "lognormal", "median": 8, "sigma": 0.7, "min": 2, "max": 16}
        mix["drain_s"] = 60
        mix["warm_s"] = 1.0
        mix["profile"] = {"start_fraction": 0.1, "seconds": 0.5}
    else:
        cfg["limits"] = {"train": {"grad_norm_gap": 1e-3, "change_norm_gap": 1e-3}}
        mix.update(batch=2, seq_len=32)
    return cell
