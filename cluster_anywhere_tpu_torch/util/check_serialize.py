"""Serializability inspection (analogue of the reference's
python/ray/util/check_serialize.py inspect_serializability): walk an object's
closure/attributes to locate the members that fail to pickle."""

from __future__ import annotations

import inspect
from typing import Any, Tuple

from ..core.serialization import pack as dumps


class FailureTuple:
    def __init__(self, obj: Any, name: str, parent: Any):
        self.obj = obj
        self.name = name
        self.parent = parent

    def __repr__(self):
        return f"FailureTuple(obj={self.name!r}, parent={self.parent!r})"


def _check(obj: Any, name: str, parent: Any, failures: list, seen: dict, depth: int):
    if id(obj) in seen:
        # cached verdict: a shared unserializable leaf fails every parent that
        # reaches it (its FailureTuple was recorded on the first walk)
        return seen[id(obj)]
    if depth > 3:
        return True
    seen[id(obj)] = True  # provisional; cycles count as ok
    try:
        dumps(obj)
        return True
    except Exception:
        pass
    seen[id(obj)] = False
    found_inner = False
    # descend into closures and attributes to find the leaf cause
    if inspect.isfunction(obj) and obj.__closure__:
        for cell, cname in zip(obj.__closure__, obj.__code__.co_freevars):
            try:
                inner = cell.cell_contents
            except ValueError:
                continue
            if not _check(inner, cname, name, failures, seen, depth + 1):
                found_inner = True
    members = getattr(obj, "__dict__", None)
    if isinstance(members, dict):
        for k, v in list(members.items())[:64]:
            if not _check(v, k, name, failures, seen, depth + 1):
                found_inner = True
    if not found_inner:
        failures.append(FailureTuple(obj, name, parent))
    return False


def inspect_serializability(obj: Any, name: str = None) -> Tuple[bool, list]:
    """Returns (serializable, failure_list); failure_list holds the deepest
    non-serializable members found."""
    name = name or getattr(obj, "__name__", repr(obj)[:40])
    failures: list = []
    ok = _check(obj, name, None, failures, {}, 0)
    return ok, failures
