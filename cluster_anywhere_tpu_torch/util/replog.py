"""Torn-tail-safe replication log for the HA plane (core/head.py).

A warm-standby head journals every replication record it receives from the
active head to an append-only file BEFORE acking it, so "acked watermark"
always means "durably applied here": after a standby restart (or a crash
mid-write) the log replays to exactly the state the active head believes
this standby holds, and the resubscribe watermark picks up from there.

Framing mirrors the head-snapshot torn-write discipline (tmp+rename there,
length+checksum here): each record is

    MAGIC(4) | length(4, LE) | crc32(4, LE) | msgpack body

A record whose header is short, whose body is truncated, or whose checksum
mismatches marks the torn tail — recovery stops THERE, truncates the file
back to the last intact record, and reports the torn flag so the standby can
log the event and re-sync the gap from its acked watermark instead of
applying a corrupt mutation.

Record schema (producer: Head._repl_emit; consumer: apply_record):
    {"t": "full",   "seq": n, "state": <msgpack blob of the snapshot dict>}
    {"t": "tables", "seq": n, "tables": {name: <msgpack blob>}}
    {"t": "kv",     "seq": n, "op": "put"|"del", "ns": s, "key": s,
     "value": bytes, "overwrite": bool}
Heartbeat records ("t": "hb") are liveness-only and are never journaled.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

MAGIC = b"CARL"
_HDR = struct.Struct("<4sII")  # magic, body length, crc32


def _frame(body: bytes) -> bytes:
    return _HDR.pack(MAGIC, len(body), zlib.crc32(body)) + body


def pack_record(record: dict) -> bytes:
    import msgpack

    return _frame(msgpack.packb(record, use_bin_type=True))


def read_records(path: str) -> Tuple[List[dict], int, bool]:
    """Scan the log, returning (intact records, good byte offset, torn?).

    `good offset` is where the first torn/corrupt record starts (== file
    size when the log is clean); everything past it must be truncated.
    """
    import msgpack

    records: List[dict] = []
    try:
        data = open(path, "rb").read()
    except FileNotFoundError:
        return records, 0, False
    off = 0
    torn = False
    n = len(data)
    while off < n:
        if off + _HDR.size > n:
            torn = True
            break
        magic, length, crc = _HDR.unpack_from(data, off)
        body_off = off + _HDR.size
        if magic != MAGIC or body_off + length > n:
            torn = True
            break
        body = data[body_off : body_off + length]
        if zlib.crc32(body) != crc:
            torn = True
            break
        try:
            records.append(msgpack.unpackb(body, raw=False, strict_map_key=False))
        except Exception:
            torn = True
            break
        off = body_off + length
    return records, off, torn


def recover(path: str) -> Tuple[List[dict], bool]:
    """Read the intact prefix and truncate any torn tail in place."""
    records, good, torn = read_records(path)
    if torn:
        with open(path, "r+b") as f:
            f.truncate(good)
    return records, torn


class ReplLogWriter:
    """Append-only journal handle.  flush-per-record (not fsync): the
    durability target is standby-process memory plus an OS-buffered journal
    — a host crash re-syncs from the active head anyway."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "ab")

    def append(self, record: dict) -> None:
        self._f.write(pack_record(record))
        self._f.flush()

    def reset(self) -> None:
        """Start a fresh log (a `full` record supersedes all history)."""
        self._f.close()
        self._f = open(self.path, "wb")

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


def apply_record(shadow: Optional[Dict[str, Any]], record: dict) -> Optional[Dict[str, Any]]:
    """Apply one replication record to the standby's shadow state dict (the
    same schema Head._snapshot_state produces).  Returns the new shadow.
    Deltas that arrive before any full state are ignored — the active head
    always opens a fresh subscription with a `full` record."""
    import msgpack

    t = record.get("t")
    if t == "full":
        return msgpack.unpackb(record["state"], raw=False, strict_map_key=False)
    if shadow is None:
        return None
    if t == "tables":
        for name, blob in (record.get("tables") or {}).items():
            shadow[name] = msgpack.unpackb(blob, raw=False, strict_map_key=False)
    elif t == "kv":
        kv = shadow.setdefault("kv", {})
        ns_name = record.get("ns", "")
        if record.get("op") == "put":
            ns = kv.setdefault(ns_name, {})
            if not (record.get("overwrite", True) is False and record["key"] in ns):
                ns[record["key"]] = record.get("value")
        else:
            ns = kv.get(ns_name)
            if ns is not None:
                ns.pop(record["key"], None)
                if not ns:
                    kv.pop(ns_name, None)
    return shadow


def replay(records: List[dict]) -> Tuple[Optional[Dict[str, Any]], int]:
    """Rebuild (shadow state, watermark) from journaled records in order."""
    shadow: Optional[Dict[str, Any]] = None
    watermark = 0
    for rec in records:
        shadow = apply_record(shadow, rec)
        watermark = max(watermark, int(rec.get("seq") or 0))
    return shadow, watermark
