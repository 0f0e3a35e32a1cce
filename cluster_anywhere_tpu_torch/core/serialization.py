"""Value serialization.

Uses cloudpickle with pickle protocol 5 out-of-band buffers so that numpy
arrays (and any buffer-exporting object) are serialized without copies: the
pickle stream holds only metadata while raw buffers are collected separately
and written directly into shared memory.  This mirrors the reference's
zero-copy plasma reads (python/ray/_private/serialization.py) in spirit.  A
CUDA tensor never goes through pickle: where torch is loaded, the picklers
refuse it (device objects are ROADMAP Queue 1 item 4) instead of copying it
to the host; CPU tensors pickle as usual.

Wire format of a serialized value (used both inline and in shm):
    meta: msgpack {pickle: bytes, buffer_lens: [int, ...]}
    followed by the concatenated raw buffers (8-byte aligned each).
"""

from __future__ import annotations

import contextlib
import io
import pickle
import sys
import threading
from typing import Any, List, Optional, Tuple

import cloudpickle
import msgpack

_ALIGN = 64


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


# --- nested-ObjectRef capture (borrowed-reference protocol) ---------------
# ObjectRef.__reduce__ appends the ref's id to the active capture list while
# a value is being pickled, so senders know which references a serialized
# value smuggles across the process boundary (reference_count.h borrowing:
# the sender pins them until the receiver registers its own).
_capture_tls = threading.local()


@contextlib.contextmanager
def ref_capture():
    """Collect ids (bytes) of ObjectRefs pickled within the block."""
    prev = getattr(_capture_tls, "refs", None)
    _capture_tls.refs = []
    try:
        yield _capture_tls.refs
    finally:
        _capture_tls.refs = prev


def note_serialized_ref(id_bytes: bytes) -> None:
    refs: Optional[list] = getattr(_capture_tls, "refs", None)
    if refs is not None:
        refs.append(id_bytes)


def _refuse_cuda(tensor):
    if tensor.is_cuda:
        from .errors import not_ported

        raise not_ported(
            f"moving a CUDA tensor {tuple(tensor.shape)}:{tensor.dtype} through the "
            "object store (device objects)", "4",
        )
    return tensor.__reduce_ex__(5)


_guarded: Optional[tuple] = None  # (Pickler, CloudPickler) that refuse CUDA tensors


def _guarded_picklers() -> Optional[tuple]:
    """Pickler classes that refuse CUDA tensors; None while torch is not
    loaded (then no value can hold one)."""
    global _guarded
    torch = sys.modules.get("torch")
    if _guarded is None and torch is not None and hasattr(torch, "Tensor"):
        tensor = torch.Tensor

        class _Pickler(pickle.Pickler):
            def reducer_override(self, obj):
                return _refuse_cuda(obj) if isinstance(obj, tensor) else NotImplemented

        class _CloudPickler(cloudpickle.CloudPickler):
            def reducer_override(self, obj):
                if isinstance(obj, tensor):
                    return _refuse_cuda(obj)
                return super().reducer_override(obj)

        _guarded = (_Pickler, _CloudPickler)
    return _guarded


def _dumps(pickler_cls, value, buffer_callback) -> bytes:
    f = io.BytesIO()
    pickler_cls(f, protocol=5, buffer_callback=buffer_callback).dump(value)
    return f.getvalue()


def serialize(value: Any) -> Tuple[bytes, List[pickle.PickleBuffer]]:
    """Returns (pickle_bytes, out_of_band_buffers).

    Plain pickle first (5-10x faster); cloudpickle only for values plain
    pickle can't handle (lambdas, local classes) — mirroring the reference's
    split between inline serialization and cloudpickled definitions."""
    buffers: List[pickle.PickleBuffer] = []
    guarded = _guarded_picklers()
    try:
        if guarded is None:
            data = pickle.dumps(value, protocol=5, buffer_callback=buffers.append)
        else:
            data = _dumps(guarded[0], value, buffers.append)
        # plain pickle serializes __main__-defined classes/functions BY
        # REFERENCE, which a worker process (different __main__) cannot
        # resolve; cloudpickle serializes them by value.  The module name is
        # embedded in the stream, so scan for it (false positives only cost
        # the slower path).
        if b"__main__" in data:
            raise pickle.PicklingError("references __main__")
    except (pickle.PicklingError, AttributeError, TypeError):
        buffers.clear()
        if guarded is None:
            data = cloudpickle.dumps(value, protocol=5, buffer_callback=buffers.append)
        else:
            data = _dumps(guarded[1], value, buffers.append)
    return data, buffers

def deserialize(data: bytes, buffers: List[Any]) -> Any:
    return pickle.loads(data, buffers=buffers)


_PACKED_NONE: bytes | None = None


def pack(value: Any) -> bytes:
    """Serialize into a single contiguous blob (inline path)."""
    global _PACKED_NONE
    if value is None:
        if _PACKED_NONE is None:
            data, _ = serialize(None)
            header = msgpack.packb({"p": data, "l": []}, use_bin_type=True)
            _PACKED_NONE = len(header).to_bytes(4, "big") + header
        return _PACKED_NONE
    data, buffers = serialize(value)
    raws = [b.raw() for b in buffers]
    header = msgpack.packb(
        {"p": data, "l": [len(r) for r in raws]}, use_bin_type=True
    )
    parts = [len(header).to_bytes(4, "big"), header]
    offset = 4 + len(header)
    for r in raws:
        pad = _align(offset) - offset
        parts.append(b"\x00" * pad)
        parts.append(bytes(r))
        offset += pad + len(r)
    return b"".join(parts)


def pack_chunks(value: Any):
    """Like pack(), but returns (total_len, chunks) without assembling one
    contiguous blob — a scatter-write sink (e.g. a shm channel) copies each
    chunk straight into place, saving a full extra copy of every large
    tensor/array buffer.  Chunk layout is byte-identical to pack()."""
    data, buffers = serialize(value)
    return pack_chunks_from_parts(data, [b.raw() for b in buffers])


def pack_chunks_from_parts(data: bytes, raws: List[Any]):
    """pack_chunks for already-serialized (pickle_bytes, raw_buffers)."""
    header = msgpack.packb(
        {"p": data, "l": [len(r) for r in raws]}, use_bin_type=True
    )
    chunks: List[Any] = [len(header).to_bytes(4, "big"), header]
    offset = 4 + len(header)
    for r in raws:
        pad = _align(offset) - offset
        if pad:
            chunks.append(b"\x00" * pad)
        chunks.append(r)
        offset += pad + len(r)
    return offset, chunks


def unpack(blob, pin_cb=None) -> Any:
    """Inverse of pack(). Accepts bytes or a memoryview (zero-copy for
    buffer-backed payloads when given a memoryview over shm).

    pin_cb: called once after ALL zero-copy buffers handed to the value have
    been garbage-collected.  Buffers are wrapped in weakref-able ndarray
    shims so the store can keep the backing slice alive exactly as long as
    any user-held view (arena slices get reused; without the pin, a view
    outliving its ObjectRef would silently read recycled bytes)."""
    mv = memoryview(blob)
    hlen = int.from_bytes(bytes(mv[:4]), "big")
    header = msgpack.unpackb(bytes(mv[4 : 4 + hlen]), raw=False)
    offset = 4 + hlen
    buffers = []
    for ln in header["l"]:
        offset = _align(offset)
        buffers.append(mv[offset : offset + ln])
        offset += ln
    if pin_cb is not None and buffers:
        import weakref

        import numpy as _np

        wrapped = [_np.frombuffer(b, dtype=_np.uint8) for b in buffers]
        remaining = {"n": len(wrapped)}

        def _one_done():
            remaining["n"] -= 1
            if remaining["n"] == 0:
                pin_cb()

        for w in wrapped:
            weakref.finalize(w, _one_done)
        return deserialize(header["p"], wrapped)
    if pin_cb is not None:
        pin_cb()  # no out-of-band buffers: nothing can alias the slice
    return deserialize(header["p"], buffers)


def packed_size(data: bytes, raws: List[Any]) -> int:
    header = msgpack.packb({"p": data, "l": [len(r) for r in raws]}, use_bin_type=True)
    offset = 4 + len(header)
    for r in raws:
        offset = _align(offset) + len(r)
    return offset


def pack_into(buf: memoryview, data: bytes, raws: List[Any]) -> int:
    """Write the pack() format into a preallocated buffer (e.g. shm mapping).
    Returns bytes written."""
    header = msgpack.packb({"p": data, "l": [len(r) for r in raws]}, use_bin_type=True)
    hlen = len(header)
    buf[:4] = hlen.to_bytes(4, "big")
    buf[4 : 4 + hlen] = header
    offset = 4 + hlen
    for r in raws:
        offset = _align(offset)
        ln = len(r)
        buf[offset : offset + ln] = r if isinstance(r, (bytes, memoryview)) else memoryview(r)
        offset += ln
    return offset
