"""Grafana dashboard factory.

Reference parity: ``dashboard/modules/metrics/grafana_dashboard_factory.py``
(generates the provisioned "default"/"serve" Grafana dashboards as JSON).
Two generators here:

- `generate_default_dashboard()` — the core dashboard: task-submit
  throughput and latency quantiles, span durations by operation, process
  RSS/CPU if exported.
- `dashboard_from_snapshot(snapshot)` — auto-factory over whatever the
  metrics registry currently exports (`util.metrics.get_metrics_snapshot`):
  counters become rate() panels, gauges plain timeseries, histograms
  p50/p99 `histogram_quantile` panels.  User-defined metrics get dashboards
  without hand-written JSON — a capability the reference's static factory
  does not have.

Output is standard Grafana dashboard JSON (schemaVersion 36) with a
`DS_PROMETHEUS` datasource variable, ready for provisioning:
`write_grafana_dashboards(dir)` drops `ca_default_dashboard.json` (+ one
per snapshot when given) alongside a provisioning YAML stub.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

_DATASOURCE = {"type": "prometheus", "uid": "${DS_PROMETHEUS}"}


def _target(expr: str, legend: str = "") -> Dict[str, Any]:
    return {
        "datasource": _DATASOURCE,
        "expr": expr,
        "legendFormat": legend or "__auto",
        "refId": "A",
    }


def _panel(
    title: str,
    targets: List[Dict[str, Any]],
    *,
    panel_id: int,
    x: int,
    y: int,
    w: int = 12,
    h: int = 8,
    unit: str = "short",
    kind: str = "timeseries",
) -> Dict[str, Any]:
    return {
        "id": panel_id,
        "title": title,
        "type": kind,
        "datasource": _DATASOURCE,
        "gridPos": {"x": x, "y": y, "w": w, "h": h},
        "fieldConfig": {"defaults": {"unit": unit}, "overrides": []},
        "targets": [dict(t, refId=chr(ord("A") + i)) for i, t in enumerate(targets)],
    }


def _dashboard(title: str, uid: str, panels: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {
        "title": title,
        "uid": uid,
        "schemaVersion": 36,
        "version": 1,
        "editable": True,
        "timezone": "browser",
        "time": {"from": "now-30m", "to": "now"},
        "refresh": "10s",
        "templating": {
            "list": [
                {
                    "name": "DS_PROMETHEUS",
                    "type": "datasource",
                    "query": "prometheus",
                    "label": "Datasource",
                }
            ]
        },
        "panels": panels,
    }


def generate_default_dashboard() -> Dict[str, Any]:
    """The core cluster dashboard over the runtime's exported series."""
    panels = [
        _panel(
            "Task submissions / s",
            [_target("rate(ca_trace_submit_latency_seconds_count[1m])", "submits")],
            panel_id=1, x=0, y=0, unit="ops",
        ),
        _panel(
            "Task submit latency",
            [
                _target(
                    "histogram_quantile(0.5, rate(ca_trace_submit_latency_seconds_bucket[5m]))",
                    "p50",
                ),
                _target(
                    "histogram_quantile(0.99, rate(ca_trace_submit_latency_seconds_bucket[5m]))",
                    "p99",
                ),
            ],
            panel_id=2, x=12, y=0, unit="s",
        ),
        _panel(
            "Span duration p99 by operation",
            [
                _target(
                    "histogram_quantile(0.99, sum by (le, name) "
                    "(rate(ca_trace_span_seconds_bucket[5m])))",
                    "{{name}}",
                )
            ],
            panel_id=3, x=0, y=8, unit="s",
        ),
        _panel(
            "Span throughput by operation",
            [_target("sum by (name) (rate(ca_trace_span_seconds_count[1m]))", "{{name}}")],
            panel_id=4, x=12, y=8, unit="ops",
        ),
        _panel(
            "Serve requests / s by deployment",
            [
                _target(
                    "sum by (deployment) (rate(ca_serve_requests_total[1m]))",
                    "{{deployment}}",
                ),
                _target(
                    "sum by (deployment) (rate(ca_serve_request_errors_total[1m]))",
                    "errors {{deployment}}",
                ),
            ],
            panel_id=5, x=0, y=16, unit="reqps",
        ),
        _panel(
            "Serve request latency p99 by deployment",
            [
                _target(
                    "histogram_quantile(0.99, sum by (le, deployment) "
                    "(rate(ca_serve_request_latency_seconds_bucket[5m])))",
                    "{{deployment}}",
                )
            ],
            panel_id=6, x=12, y=16, unit="s",
        ),
    ]
    return _dashboard("cluster_anywhere_tpu_torch — core", "ca-default", panels)


def dashboard_from_snapshot(
    snapshot: Dict[str, dict], title: str = "cluster_anywhere_tpu_torch — metrics",
    uid: str = "ca-metrics",
) -> Dict[str, Any]:
    """Auto-generate panels from a metrics-registry snapshot
    (`util.metrics.get_metrics_snapshot()` shape: name -> {"type", ...})."""
    panels: List[Dict[str, Any]] = []
    pid = 0
    x = y = 0
    for name, rec in sorted(snapshot.items()):
        pid += 1
        kind = rec.get("type")
        if kind == "counter":
            targets = [_target(f"rate({name}[1m])", name)]
            unit = "ops"
        elif kind == "histogram":
            targets = [
                _target(
                    f"histogram_quantile(0.5, rate({name}_bucket[5m]))", "p50"
                ),
                _target(
                    f"histogram_quantile(0.99, rate({name}_bucket[5m]))", "p99"
                ),
            ]
            unit = "short"
        else:  # gauge (and anything unknown renders as a plain series)
            targets = [_target(name, name)]
            unit = "short"
        panels.append(
            _panel(name, targets, panel_id=pid, x=x, y=y, unit=unit)
        )
        x = 12 - x  # two panels per row
        if x == 0:
            y += 8
    return _dashboard(title, uid, panels)


_PROVISIONING_YAML = """apiVersion: 1
providers:
  - name: cluster_anywhere_tpu_torch
    folder: cluster_anywhere_tpu_torch
    type: file
    options:
      path: {path}
"""


def write_grafana_dashboards(
    out_dir: str, snapshot: Optional[Dict[str, dict]] = None
) -> List[str]:
    """Write dashboard JSON (+ provisioning stub) under `out_dir`; returns
    the written paths.  CLI: ``ca metrics --grafana-out DIR``."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for fname, dash in [("ca_default_dashboard.json", generate_default_dashboard())] + (
        [("ca_metrics_dashboard.json", dashboard_from_snapshot(snapshot))]
        if snapshot else []
    ):
        path = os.path.join(out_dir, fname)
        with open(path, "w") as f:
            json.dump(dash, f, indent=1)
        written.append(path)
    prov = os.path.join(out_dir, "provisioning.yaml")
    with open(prov, "w") as f:
        f.write(_PROVISIONING_YAML.format(path=os.path.abspath(out_dir)))
    written.append(prov)
    return written
