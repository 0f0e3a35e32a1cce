"""The traced sub-window: torch.profiler over a few seconds of a run, reduced
to what the per-layer readers and the result line need.

The profiler is entered and left on the thread that launches the program's
device work, so its ranges are recorded where the kernels start.  Every
phase the harness marks (a `perfbench.<phase>` range) ends in a
synchronisation in the program (an admission reads its first token, a
decode step copies its tokens to the host), so a kernel belongs to the
range its start falls in.
"""

from __future__ import annotations

import bisect
import time
from typing import Any, Dict, List, Optional, Tuple


class Trace:
    """prepare() (the profiler's slow first set-up), then begin() and end()
    on the thread that launches the work, then reduce() anywhere: fills
    .summary."""

    def __init__(self):
        self.prof = None
        self.t0 = self.window_s = None
        self.summary: Optional[Dict[str, Any]] = None

    def prepare(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.prepare_trace()

    def begin(self):
        import torch

        if self.prof is None:
            self.prepare()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.start_trace()
        self.t0 = time.perf_counter()

    def end(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop_trace()

    def reduce(self) -> Dict[str, Any]:
        t = time.perf_counter()
        self.summary = reduce(self.prof.events(), self.window_s)
        self.summary["reduce_s"] = time.perf_counter() - t
        self.prof = None
        return self.summary


def _is_kernel(e) -> bool:
    from torch.autograd import DeviceType

    return e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)


def reduce(events, window_s: float) -> Dict[str, Any]:
    """kernels: [(name, start_us, dur_us, phase)], phase being the
    innermost perfbench range the kernel started in (or None); busy_s: the
    union of the kernels' intervals; ranges: [(name, start_us, end_us)];
    cpu_ops: the host's ops, for labelling idle gaps."""
    kernels, ranges, cpu = [], [], []
    for e in events:
        if _is_kernel(e):
            kernels.append((e.name, e.time_range.start, e.time_range.end - e.time_range.start))
        elif e.name.startswith("perfbench."):
            ranges.append((e.name[len("perfbench."):], e.time_range.start, e.time_range.end))
        elif e.device_type.name == "CPU":
            cpu.append((e.name, e.time_range.start, e.time_range.end))
    kernels.sort(key=lambda k: k[1])
    ranges.sort(key=lambda r: r[1])
    cpu.sort(key=lambda r: r[1])
    starts = [r[1] for r in ranges]
    labelled = [(n, s, d, _innermost(ranges, starts, s)) for n, s, d in kernels]
    busy_us, reach = 0.0, None
    gaps: List[Tuple[float, float]] = []
    for _, s, d, _ in labelled:
        e = s + d
        if reach is None or s > reach:
            if reach is not None:
                gaps.append((reach, s))
            busy_us += d
            reach = e
        elif e > reach:
            busy_us += e - reach
            reach = e
    return {
        "kernels": labelled,
        "ranges": ranges,
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "gaps": gaps,
        "cpu_ops": cpu,
    }


def _innermost(spans, starts, t, limit: int = 4096) -> Optional[str]:
    """The name of the latest-starting span (name, start, end) holding time
    t; spans sorted by start, `starts` their starts."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - limit), -1):
        if spans[j][2] >= t:
            return spans[j][0]
    return None


def kernel_ms(summary, keys, phase=None) -> float:
    """Device ms of the kernels whose lowercased name holds any of `keys`,
    in `phase` if given."""
    return sum(d for n, _, d, p in summary["kernels"]
               if any(k in n.lower() for k in keys) and (phase is None or p == phase)) / 1e3


def phase_ms(summary, phase) -> float:
    return sum(d for _, _, d, p in summary["kernels"] if p == phase) / 1e3


def breakdown(summary, top: int = 10) -> Dict[str, List]:
    """The device operations that took most time, and the longest idle time
    by what the host was doing then (the innermost host op running at the
    gap's middle), each as [name, seconds]."""
    by_op: Dict[str, float] = {}
    for n, _, d, _ in summary["kernels"]:
        by_op[n[:120]] = by_op.get(n[:120], 0.0) + d / 1e6
    ops = summary["cpu_ops"]
    starts = [o[1] for o in ops]
    by_host: Dict[str, float] = {}
    for a, b in summary["gaps"]:
        label = _innermost(ops, starts, (a + b) / 2) or "no host op recorded"
        by_host[label[:120]] = by_host.get(label[:120], 0.0) + (b - a) / 1e6
    return {
        "device_ops": [[k, v] for k, v in sorted(by_op.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[k, v] for k, v in sorted(by_host.items(), key=lambda kv: -kv[1])[:top]],
    }
