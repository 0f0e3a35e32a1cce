"""BENCHMARK.json and the files it names.

A cell's configuration, traffic and per-layer readers are found by the names
the manifest gives them, so a later cell, configuration or metric is a new
file and a new entry, never an edit.  Names and units are checked against the
benchmark's character sets before anything runs.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME_RE = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT_RE = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


class ManifestError(ValueError):
    pass


def check_name(name: Any, what: str) -> str:
    if not isinstance(name, str) or not NAME_RE.fullmatch(name):
        raise ManifestError(f"{what} {name!r}: a name is 1-64 of [A-Za-z0-9_.-], not starting "
                            f"with . or -")
    return name


def check_unit(unit: Any, what: str) -> str:
    if not isinstance(unit, str) or not UNIT_RE.fullmatch(unit):
        raise ManifestError(f"{what}: unit {unit!r} is not 1-16 of [A-Za-z0-9_/%.-]")
    return unit


def load(root: Path = ROOT) -> Dict[str, Any]:
    """BENCHMARK.json at `root`, its names and units checked."""
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise ManifestError(f"no BENCHMARK.json at {root}")
    man = json.loads(path.read_text())
    for c in man["configs"]:
        check_name(c["name"], "config")
        for key in c.get("reduced", []):
            check_name(key, f"config {c['name']}: reduced key")
    for w in man["workloads"]:
        check_name(w["name"], "workload")
        check_name(w["config"], f"workload {w['name']}: config")
        check_name(w["traffic"], f"workload {w['name']}: traffic")
    for group in ("end_to_end", "per_layer"):
        for m in man[group]:
            check_name(m["name"], group)
            check_unit(m["unit"], f"{group} {m['name']}")
    return man


def workload(man: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise ManifestError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(man: Dict[str, Any], name: str) -> Dict[str, Any]:
    for c in man["configs"]:
        if c["name"] == name:
            return c
    raise ManifestError(f"no config {name!r} in BENCHMARK.json")


def read_json(rel: str, root: Path = ROOT) -> Dict[str, Any]:
    return json.loads((Path(root) / rel).read_text())


def traffic(name: str) -> Dict[str, Any]:
    """traffic/<name>.json: the mix's parameters."""
    return json.loads((HERE / "traffic" / f"{check_name(name, 'traffic')}.json").read_text())


def cell(man: Dict[str, Any], name: str, root: Path = ROOT) -> Dict[str, Any]:
    """Everything one run of workload `name` needs: its entry, its config
    file's contents, its traffic, and the metrics it reports."""
    w = workload(man, name)
    c = config_entry(man, w["config"])
    return {
        "name": name,
        "workload": w,
        "config": read_json(c["file"], root),
        "traffic": traffic(w["traffic"]),
        "end_to_end": metrics_for(man, "end_to_end", name),
        "per_layer": metrics_for(man, "per_layer", name),
    }


def metrics_for(man: Dict[str, Any], group: str, name: str) -> List[Dict[str, Any]]:
    """The metrics of `group` this workload reports: those whose `workloads`
    list it, and those without the key (per-layer ones only where the cell
    reports the end-to-end metric they move)."""
    e2e = {m["name"] for m in man["end_to_end"] if name in m.get("workloads", [name])}
    out = []
    for m in man[group]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif group == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def _load_module(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    """metrics/<metric>.py's read()."""
    path = HERE / "metrics" / f"{check_name(metric, 'metric')}.py"
    if not path.is_file():
        raise ManifestError(f"no reader {path.name} for per-layer metric {metric!r}")
    return _load_module(path, "perfbench_metric_" + re.sub(r"\W", "_", metric)).read


def driver(kind: str):
    """cells/<kind>.py (the module perfbench.cells.<kind>): the driver of a
    traffic kind."""
    if not kind.isidentifier() or not (HERE / "cells" / f"{kind}.py").is_file():
        raise ManifestError(f"no driver cells/{kind}.py for traffic kind {kind!r}")
    return importlib.import_module(f"perfbench.cells.{kind}")


def model_dims(config: Dict[str, Any]) -> Dict[str, Any]:
    """The sizes a configuration file gives, under the names the harness and
    the reference use.  `n_layers` is the layers this configuration runs."""
    e, h = config["hidden_size"], config["num_attention_heads"]
    return {
        "vocab": config["vocab_size"],
        "d_model": e,
        "n_layers": config["num_hidden_layers"],
        "n_heads": h,
        "n_kv_heads": config.get("num_key_value_heads", h),
        "d_head": config.get("head_dim") or e // h,
        "d_ff": config["intermediate_size"],
        "max_seq_len": config["max_position_embeddings"],
        "rope_theta": float(config.get("rope_theta", 10000.0)),
        "eps": float(config["rms_norm_eps"]),
        "dtype": config["precision"]["activations"],
        "param_dtype": config["precision"]["params"],
    }
