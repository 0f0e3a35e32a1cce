"""Function/actor-class export and caching.

The reference exports pickled function definitions once to GCS KV and workers
import them on first use (python/ray/_private/function_manager.py,
gcs_function_manager.h).  Same here: definitions are content-addressed by
sha256 of the cloudpickle blob, uploaded to the head KV once per driver, and
cached per worker process.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import cloudpickle


class FunctionManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._by_id: Dict[bytes, Any] = {}  # fn_id -> callable / class
        self._exported: set = set()  # fn_ids known to be in head KV
        self._blob_cache: Dict[int, Tuple[bytes, bytes]] = {}  # id(obj) -> (fn_id, blob)
        self._blob_by_id: Dict[bytes, bytes] = {}  # fn_id -> blob (exporter side)

    def export(self, obj: Any) -> Tuple[bytes, Optional[bytes]]:
        """Returns (fn_id, blob_to_upload_or_None_if_already_exported)."""
        key = id(obj)
        with self._lock:
            cached = self._blob_cache.get(key)
            if cached is not None:
                fn_id, blob = cached
                return fn_id, (None if fn_id in self._exported else blob)
        blob = cloudpickle.dumps(obj)
        fn_id = hashlib.sha256(blob).digest()[:16]
        with self._lock:
            self._blob_cache[key] = (fn_id, blob)
            self._blob_by_id[fn_id] = blob
            self._by_id[fn_id] = obj
            if fn_id in self._exported:
                return fn_id, None
            return fn_id, blob

    def blob_for(self, fn_id: bytes) -> Optional[bytes]:
        """The exported blob of a function THIS process exported (None for
        functions learned by id only).  Lets a submitter inline the
        definition into a task push while the head — the normal blob
        directory — is down (lease-plane grants keep flowing through head
        restarts, so pushes must not depend on head-served blobs)."""
        with self._lock:
            return self._blob_by_id.get(fn_id)

    def mark_exported(self, fn_id: bytes):
        with self._lock:
            self._exported.add(fn_id)

    def get(self, fn_id: bytes) -> Optional[Any]:
        with self._lock:
            return self._by_id.get(fn_id)

    def load(self, fn_id: bytes, blob: bytes) -> Any:
        obj = cloudpickle.loads(blob)
        with self._lock:
            self._by_id[fn_id] = obj
        return obj
