"""GPU accelerator manager: device counting feeding the resource model.

Reference parity: ``python/ray/_private/accelerators/nvidia_gpu.py``
(NvidiaGPUAcceleratorManager).  Detection never imports torch or opens a CUDA
context: a ``CUDA_VISIBLE_DEVICES`` restriction wins, then the driver's
``/proc/driver/nvidia/gpus/*`` entries, then the ``/dev/nvidia<N>`` device
files this process may open (a container can list a card's node that its
device cgroup refuses).

Detected GPUs surface as the schedulable ``GPU`` resource at ``init``; the
TPU package's pod and topology markers have no counterpart on a GPU host.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, Optional

RESOURCE_NAME = "GPU"

VISIBLE_CHIPS_ENV = "CUDA_VISIBLE_DEVICES"
NOSET_VISIBLE_CHIPS_ENV = "CA_EXPERIMENTAL_NOSET_CUDA_VISIBLE_DEVICES"


def visible_chip_ids() -> Optional[list]:
    """GPU ids this process may use, or None when unrestricted
    (get_current_process_visible_accelerator_ids analogue).  CUDA stops at
    the first negative id."""
    v = os.environ.get(VISIBLE_CHIPS_ENV)
    if v is None:
        return None
    ids = []
    for s in (s.strip() for s in v.split(",")):
        if not s or s.startswith("-"):
            break
        ids.append(s)
    return ids


def _openable(path: str) -> bool:
    try:
        os.close(os.open(path, os.O_RDWR))
        return True
    except OSError:
        return False


def num_gpus() -> int:
    """GPUs on this host.  Priority: visible-devices restriction, the
    driver's /proc entries, the /dev/nvidia<N> files this process can open."""
    vis = visible_chip_ids()
    if vis is not None:
        return len(vis)
    procs = glob.glob("/proc/driver/nvidia/gpus/*")
    if procs:
        return len(procs)
    nodes = [p for p in glob.glob("/dev/nvidia*") if re.fullmatch(r"/dev/nvidia\d+", p)]
    return sum(_openable(p) for p in nodes)


def validate_chip_request(n: float) -> None:
    """GPU requests are a positive whole count or a fraction <1 of one GPU
    (validate_resource_request_quantity)."""
    if n <= 0:
        raise ValueError(f"GPU request must be positive, got {n}")
    if n > 1 and n != int(n):
        raise ValueError(f"GPU request of {n} is invalid: above one GPU, ask for whole GPUs")


class ChipAllocator:
    """Per-host GPU assignment for spawned GPU workers.

    Least-loaded assignment: 1:1 pinning while workers <= GPUs, and stable
    sharing (never an unrestricted view) once fractional requests oversubscribe
    a GPU.  Honors a parent process's CUDA_VISIBLE_DEVICES restriction — ids
    are drawn from that set, not range(n).
    """

    def __init__(self, n_chips: int):
        vis = visible_chip_ids()
        ids = vis if vis is not None else [str(i) for i in range(max(n_chips, 0))]
        self._load: Dict[str, int] = {cid: 0 for cid in ids}

    def acquire(self) -> Optional[str]:
        if not self._load:
            return None
        cid = min(self._load, key=lambda c: (self._load[c], c))
        self._load[cid] += 1
        return cid

    def release(self, cid: Optional[str]) -> None:
        if cid is not None and self._load.get(cid, 0) > 0:
            self._load[cid] -= 1


def detect_node_labels(node_id: Optional[str] = None) -> Dict[str, str]:
    """The one label-derivation used by every node: CA_NODE_LABELS env
    labels (+ ca.io/node-id when the caller knows it).  Head-embedded node
    and agents must share this, or NodeLabelSchedulingStrategy selectors
    behave differently per node kind."""
    labels = parse_labels_env(os.environ.get("CA_NODE_LABELS"))
    if node_id is not None:
        labels["ca.io/node-id"] = node_id
    return labels


def parse_labels_env(env_val: Optional[str]) -> Dict[str, str]:
    """Parse a CA_NODE_LABELS-style JSON object into a str->str label map;
    malformed or non-object JSON yields {} (a bad env var must not kill a
    node agent at startup)."""
    if not env_val:
        return {}
    import json

    try:
        obj = json.loads(env_val)
    except ValueError:
        return {}
    if not isinstance(obj, dict):
        return {}
    return {str(k): str(v) for k, v in obj.items()}


def visible_chips_env_for_worker(chip_id) -> Dict[str, str]:
    """Env a spawned GPU-pool worker should receive to pin it to one GPU
    (set_current_process_visible_accelerator_ids analogue).  Empty when
    pinning is disabled or no GPU was assigned."""
    if chip_id is None or os.environ.get(NOSET_VISIBLE_CHIPS_ENV):
        return {}
    return {VISIBLE_CHIPS_ENV: str(chip_id)}
