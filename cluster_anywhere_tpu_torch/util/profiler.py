"""In-process sampling profiler (the `ca profile` engine; analogue of the
reference's py-spy-backed `ray stack`/dashboard CPU profiler, but built on
`sys._current_frames()` so it needs no external binary and no ptrace
permission — the sampled process samples itself on a side thread).

`sample_stacks()` runs a wall-clock sampler for a bounded duration and folds
each observed stack into `root;caller;...;leaf -> count` form.  Two renders:
`render_folded()` (flamegraph.pl / speedscope-pasteable text) and
`speedscope_json()` (the sampled-profile speedscope schema, loadable at
https://speedscope.app).  `rusage_probe()` is the cheap point-in-time
CPU/RSS sample the worker attaches to terminal task events so the timeline
carries resource attribution without a profiler run.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

MAX_DURATION_S = 60.0  # a forgotten `ca profile --duration 1e9` must end
MAX_DEPTH = 128


def _frame_label(frame) -> str:
    co = frame.f_code
    return f"{co.co_name} ({os.path.basename(co.co_filename)}:{frame.f_lineno})"


def _fold(frame) -> str:
    parts: List[str] = []
    depth = 0
    while frame is not None and depth < MAX_DEPTH:
        parts.append(_frame_label(frame))
        frame = frame.f_back
        depth += 1
    parts.reverse()
    return ";".join(parts)


def sample_stacks(
    duration_s: float = 2.0,
    hz: float = 100.0,
    all_threads: bool = False,
) -> Dict[str, Any]:
    """Sample this process's stacks for `duration_s` at `hz`.  By default
    only non-sampler, non-daemon-idle *busy candidates* — every thread except
    the sampler itself — are folded; `all_threads=False` additionally drops
    threads parked in the sampler's own wait primitives.  Returns
    {"folded": {stack: count}, "samples": n, "duration_s": d, "hz": hz}.

    The sampler runs on the CALLING thread (callers put it on an executor
    thread; the worker's IO loop must keep serving heartbeats while the
    profile runs)."""
    duration_s = max(0.05, min(float(duration_s), MAX_DURATION_S))
    hz = max(1.0, min(float(hz), 1000.0))
    period = 1.0 / hz
    me = threading.get_ident()
    folded: Dict[str, int] = {}
    n = 0
    deadline = time.monotonic() + duration_s
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            if not all_threads:
                # skip stacks idling in interpreter-internal waits (executor
                # threads between tasks, selector threads): they are noise
                # that buries the busy thread in a merged flame view
                name = frame.f_code.co_name
                if name in ("_worker", "wait", "select", "_run_once", "run"):
                    leaf_file = os.path.basename(frame.f_code.co_filename)
                    if leaf_file in (
                        "threading.py", "selectors.py", "thread.py",
                        "base_events.py", "queue.py",
                    ):
                        continue
            stack = _fold(frame)
            if stack:
                folded[stack] = folded.get(stack, 0) + 1
                n += 1
        time.sleep(period)
    return {"folded": folded, "samples": n, "duration_s": duration_s, "hz": hz}


def render_folded(folded: Dict[str, int], limit: Optional[int] = None) -> str:
    """Folded-stack text, heaviest stacks first (flamegraph.pl input)."""
    rows = sorted(folded.items(), key=lambda kv: -kv[1])
    if limit:
        rows = rows[:limit]
    return "\n".join(f"{stack} {count}" for stack, count in rows)


def top_functions(folded: Dict[str, int], limit: int = 10) -> List[tuple]:
    """(leaf function, self samples) heaviest-first — the `ca profile`
    one-glance summary before the full folded dump."""
    leaf: Dict[str, int] = {}
    for stack, count in folded.items():
        fn = stack.rsplit(";", 1)[-1]
        leaf[fn] = leaf.get(fn, 0) + count
    return sorted(leaf.items(), key=lambda kv: -kv[1])[:limit]


def speedscope_json(
    folded: Dict[str, int], name: str = "ca profile", hz: float = 100.0
) -> Dict[str, Any]:
    """Speedscope "sampled" profile from folded counts.  Each unique stack
    becomes one sample whose weight is its observed share of wall time."""
    frame_index: Dict[str, int] = {}
    frames: List[Dict[str, str]] = []
    samples: List[List[int]] = []
    weights: List[float] = []
    dt = 1.0 / max(hz, 1.0)
    for stack, count in sorted(folded.items(), key=lambda kv: -kv[1]):
        idxs = []
        for label in stack.split(";"):
            i = frame_index.get(label)
            if i is None:
                i = frame_index[label] = len(frames)
                frames.append({"name": label})
            idxs.append(i)
        samples.append(idxs)
        weights.append(count * dt)
    total = sum(weights)
    return {
        "$schema": "https://www.speedscope.app/file-format-schema.json",
        "shared": {"frames": frames},
        "profiles": [
            {
                "type": "sampled",
                "name": name,
                "unit": "seconds",
                "startValue": 0,
                "endValue": total,
                "samples": samples,
                "weights": weights,
            }
        ],
        "exporter": "cluster_anywhere_tpu",
    }


# ------------------------------------------------------------------- rusage


def rusage_probe() -> Dict[str, float]:
    """Point-in-time process resource sample: cumulative CPU seconds and
    max RSS.  Two probes bracketing a task give CPU%% over its wall time
    (process-wide — concurrent tasks on one worker share the number, which
    the timeline view labels as such)."""
    out: Dict[str, float] = {"cpu_s": time.process_time()}
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        # ru_maxrss is KiB on linux, bytes on macOS; normalize to bytes
        scale = 1024 if sys.platform != "darwin" else 1
        out["max_rss_bytes"] = float(ru.ru_maxrss) * scale
    except Exception:
        pass
    return out


def rusage_delta(
    t0_wall: float, probe0: Dict[str, float], arena_bytes: Optional[int] = None
) -> Dict[str, float]:
    """Finish-side half of the bracket: CPU%% of wall time since `t0_wall`,
    current max RSS, and (when the caller can see its shm store) live arena
    bytes — the fields attached to terminal task events."""
    p1 = rusage_probe()
    wall = max(time.time() - t0_wall, 1e-9)
    out = {
        "cpu_pct": round(100.0 * (p1["cpu_s"] - probe0.get("cpu_s", 0.0)) / wall, 1),
        "max_rss_bytes": p1.get("max_rss_bytes", 0.0),
    }
    if arena_bytes is not None:
        out["arena_bytes"] = float(arena_bytes)
    return out
