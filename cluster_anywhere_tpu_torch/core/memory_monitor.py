"""Node memory monitor + worker-killing policy.

Reference parity: ``src/ray/common/memory_monitor.h:52`` (periodic usage
sampling against a kill threshold) and
``src/ray/raylet/worker_killing_policy.h`` (pick which worker dies when the
node is about to OOM).  The policy here mirrors the reference's retriable-
first / LIFO preference: killing the newest retriable work loses the least
progress and the runtime's existing retry machinery transparently re-runs it.

The monitor itself is process-agnostic: the head runs one over its local
node's workers and every node agent runs one over its own (the kill is
always taken by the process that owns the worker's pid).
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence, Tuple

# Sampling sources, in preference order (first readable wins):
#   1. CA_TEST_MEM_USAGE_PATH — a test-injected file "used_bytes total_bytes"
#   2. cgroup v2  (/sys/fs/cgroup/memory.current + memory.max)
#   3. cgroup v1  (memory.usage_in_bytes + memory.limit_in_bytes)
#   4. /proc/meminfo (MemTotal - MemAvailable)
_CG2 = "/sys/fs/cgroup"
_CG1 = "/sys/fs/cgroup/memory"
# limits above this are "no limit" sentinels (cgroup v1 reports PAGE_COUNTER_MAX)
_NO_LIMIT = 1 << 60


def _read_int(path: str) -> Optional[int]:
    try:
        with open(path) as f:
            txt = f.read().strip()
        if txt == "max":
            return None
        return int(txt)
    except (OSError, ValueError):
        return None


def _meminfo() -> Optional[Tuple[int, int]]:
    try:
        fields = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, rest = line.partition(":")
                fields[k] = int(rest.split()[0]) * 1024
        total = fields["MemTotal"]
        avail = fields.get("MemAvailable", fields.get("MemFree", 0))
        return total - avail, total
    except (OSError, KeyError, ValueError, IndexError):
        return None


class MemoryMonitor:
    """Samples node memory usage and answers "are we about to OOM?".

    ``threshold`` is the used/total fraction above which the killing policy
    engages (memory_monitor.h's usage_threshold, default 0.95).
    """

    def __init__(self, threshold: float = 0.95):
        self.threshold = threshold

    def sample(self) -> Optional[Tuple[int, int]]:
        """(used_bytes, total_bytes), or None if nothing is readable."""
        test_path = os.environ.get("CA_TEST_MEM_USAGE_PATH")
        if test_path:
            try:
                with open(test_path) as f:
                    used, total = f.read().split()
                return int(used), int(total)
            except (OSError, ValueError):
                return None  # test hook present but unreadable: no verdict
        cur = _read_int(os.path.join(_CG2, "memory.current"))
        lim = _read_int(os.path.join(_CG2, "memory.max"))
        if cur is not None and lim is not None and lim < _NO_LIMIT:
            return cur, lim
        cur = _read_int(os.path.join(_CG1, "memory.usage_in_bytes"))
        lim = _read_int(os.path.join(_CG1, "memory.limit_in_bytes"))
        if cur is not None and lim is not None and lim < _NO_LIMIT:
            return cur, lim
        return _meminfo()

    def is_pressured(self) -> bool:
        s = self.sample()
        if s is None:
            return False
        used, total = s
        return total > 0 and used / total > self.threshold


class Candidate(NamedTuple):
    """One worker the killing policy may choose.

    ``retriable`` means killing it only costs a transparent re-run — an
    actor with restarts left, or a leased task worker (leases carry no
    per-task retry budget, so the policy assumes the configured default
    budget > 0; a max_retries=0 task on a leased worker is the accepted
    imprecision of that assumption).  ``busy_since`` is the monotonic time
    the current work started (0 if unknown).
    """

    worker: object
    is_idle: bool
    retriable: bool
    busy_since: float


def pick_victim(cands: Sequence[Candidate]) -> Optional[object]:
    """Choose the worker to kill under memory pressure.

    Order of preference (worker_killing_policy.h group policy, condensed):
      1. idle workers — free memory without losing any work at all;
      2. retriable busy workers, newest work first (LIFO: least progress lost);
      3. non-retriable busy workers, newest first (last resort — the caller
         sees a crash, but the node survives).
    Returns the chosen ``Candidate.worker``, or None if ``cands`` is empty.
    """
    idle = [c for c in cands if c.is_idle]
    if idle:
        # newest-started idle worker: the prestarted pool keeps its elders
        return max(idle, key=lambda c: c.busy_since).worker
    retriable = [c for c in cands if c.retriable]
    pool = retriable or list(cands)
    if not pool:
        return None
    return max(pool, key=lambda c: c.busy_since).worker
