"""BENCHMARK.json, its checks and the files it names."""

import json
import re
from pathlib import Path

import pytest

from perfbench import manifest

ROOT = Path(manifest.ROOT)


def man():
    return manifest.load()


def test_every_name_resolves_to_its_file():
    m = man()
    for w in m["workloads"]:
        cell = manifest.cell(m, w["name"])
        assert manifest.driver(cell["traffic"]["kind"]).run
        assert cell["end_to_end"] and cell["per_layer"]
        assert any(e["name"] == "setup_s" for e in cell["end_to_end"])
    for metric in m["per_layer"]:
        assert callable(manifest.reader(metric["name"]))
    for c in m["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith(tuple(p + "/" for p in m["paths"]))


@pytest.mark.parametrize("bad", ["a b", "a,b", "a/b", ".hidden", "-x", "µs", "", "x" * 65, 7])
def test_refuses_bad_names(bad):
    with pytest.raises(manifest.ManifestError):
        manifest.check_name(bad, "test")


@pytest.mark.parametrize("good", ["dsllm7b.chat", "admit_ms.chat", "deepseek-llm-7b", "_x", "9"])
def test_takes_good_names(good):
    assert manifest.check_name(good, "test") == good


@pytest.mark.parametrize("bad", ["tokens per second", "µs", "", "x" * 17, "a,b"])
def test_refuses_bad_units(bad):
    with pytest.raises(manifest.ManifestError):
        manifest.check_unit(bad, "test")


@pytest.mark.parametrize("good", ["tokens/s", "%", "ms", "s"])
def test_takes_good_units(good):
    assert manifest.check_unit(good, "test") == good


def test_load_refuses_a_bad_metric_name(tmp_path):
    m = man()
    m["per_layer"][0]["name"] = "admit ms"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    with pytest.raises(manifest.ManifestError):
        manifest.load(tmp_path)


def test_missing_reader_and_driver_are_refused():
    with pytest.raises(manifest.ManifestError):
        manifest.reader("no_such_metric")
    with pytest.raises(manifest.ManifestError):
        manifest.driver("no_such_kind")


def test_contract_shape():
    m = man()
    assert set(m) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= m["run_seconds"] <= 51 and isinstance(m["run_seconds"], int)
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for e in m["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= e["bound"] <= 0.25 and e["source"] in ("host_clock", "device_trace")
    e2e = {e["name"] for e in m["end_to_end"]}
    for p in m["per_layer"]:
        assert set(p) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert p["moves"] in e2e
        if re.search(r"roofline|mfu", p["name"]):
            assert p["unit"] == "%"
    for w in m["workloads"]:
        reported = [e for e in m["end_to_end"] if w["name"] in e.get("workloads", [w["name"]])]
        assert len(reported) >= 2


def test_metrics_for_without_a_workloads_key():
    m = man()
    m["per_layer"].append({"name": "x.any", "unit": "%", "better": "higher", "source": "device_trace",
                           "layer": "device", "moves": "train_tok_s"})
    names = [p["name"] for p in manifest.metrics_for(m, "per_layer", "dsllm7b-stage8.train")]
    assert "x.any" in names
    names = [p["name"] for p in manifest.metrics_for(m, "per_layer", "dsllm7b.chat")]
    assert "x.any" not in names


def test_model_dims_of_the_configurations():
    a = manifest.model_dims(manifest.read_json("perfbench/configs/deepseek-llm-7b.json"))
    assert (a["d_model"], a["n_layers"], a["n_heads"], a["n_kv_heads"], a["d_head"], a["d_ff"],
            a["vocab"]) == (4096, 30, 32, 32, 128, 11008, 102400)
    b = manifest.model_dims(manifest.read_json("perfbench/configs/deepseek-llm-7b-stage8.json"))
    assert b["n_layers"] == 8 and b["param_dtype"] == "float32"
