"""Versioned shared-memory channels.

Wire format of a slot (all u64 little-endian, 8-byte aligned):

    [magic][version][payload_len][flags][num_readers][ack_0]...[ack_{R-1}] payload...

Protocol (single writer, R registered readers):
  - writer waits until every ack == version, serializes the value into the
    payload area, then publishes by storing version+1;
  - reader r waits until version > ack_r, deserializes, stores ack_r = version.
An 8-byte aligned store through mmap is effectively atomic on the platforms we
target (x86-64/ARM64), and the version store is the release point — payload is
written before version advances, matching the reference's seal-then-notify
semantics (plasma mutable objects, experimental_mutable_object_manager.h:49).

Backing storage is a plain /dev/shm file mmap'd by writer and readers (same
mechanism as core/object_store.py), placed inside the session's shm directory
so stale-session sweeping reclaims it.

Oversized payloads spill to the distributed object store and the channel
carries only the ObjectRef (the reference resizes its backing store;
spill-through keeps the segment bounded instead).
"""

from __future__ import annotations

import mmap
import os
import queue as _queue
import struct
import threading as _threading
import time
import uuid
from typing import Any, List, Optional

_MAGIC = 0x00CA_C4A9
_U64 = struct.Struct("<Q")
_FLAG_CLOSED = 1
_SPILL_BIT = 1 << 63  # payload_len high bit: payload is a spilled ObjectRef

_DEFAULT_BUFFER = 8 * 1024 * 1024
_POLL_S = 20e-6

# hot-path counters, plain ints bumped without a lock (same contract as
# protocol.WIRE_STATS: a lost increment under a race is acceptable, a lock
# in a microsecond-scale channel write is not); util/metrics delta-ships
# them as ca_channel_* cluster counters on every flush
CHANNEL_STATS = {
    "writes": 0,           # payloads published (per underlying slot write)
    "reads": 0,            # payloads consumed
    "spills": 0,           # oversized payloads routed through the object store
    "backpressure_waits": 0,  # writes that found a reader ack outstanding
    "closes": 0,           # close() flags raised
}


class ChannelClosedError(Exception):
    """Raised by read/write when the channel has been shut down."""


class ChannelInterface:
    def write(self, value: Any, timeout: Optional[float] = None):
        raise NotImplementedError

    def read(self, timeout: Optional[float] = None) -> Any:
        raise NotImplementedError

    def close(self):
        raise NotImplementedError


def _now():
    return time.monotonic()


def _chan_dir() -> str:
    """Channel files live under the session's /dev/shm dir so a crashed
    session's sweep (core/api.py:_sweep_stale_sessions) reclaims them."""
    from ..core.worker import try_global_worker

    w = try_global_worker()
    if w is not None and getattr(w, "session_dir", None):
        d = os.path.join("/dev/shm", os.path.basename(w.session_dir))
        os.makedirs(d, exist_ok=True)
        return d
    return "/dev/shm"


class ShmChannel(ChannelInterface):
    """Single-slot channel. Create once (driver side), open by spec elsewhere."""

    def __init__(
        self,
        num_readers: int = 1,
        buffer_size: int = _DEFAULT_BUFFER,
        *,
        path: Optional[str] = None,
    ):
        self.num_readers = num_readers
        self.header_size = 8 * (5 + num_readers)
        self.reader_index = 0
        self._created = path is None
        if path is None:
            path = os.path.join(_chan_dir(), f"chan_{uuid.uuid4().hex[:16]}")
            size = buffer_size + self.header_size
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, size)
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
            self._init_header()
        else:
            fd = os.open(path, os.O_RDWR)
            try:
                size = os.fstat(fd).st_size
                self._mm = mmap.mmap(fd, size)
            finally:
                os.close(fd)
        self.path = path
        self.capacity = len(self._mm) - self.header_size
        self._last_spill = None
        # waiter accounting so release() can't unmap the segment while another
        # thread is blocked in the native futex wait on a raw address inside
        # it (ADVICE r1: use-after-unmap). _released is process-local (unlike
        # the shared close flag, which would close the channel for everyone).
        self._released = False
        self._waiters = 0
        self._waiters_lock = _threading.Lock()
        # native futex wait/wake (microsecond wakeups, no spin): fall back to
        # 20us polling when the native library is unavailable
        self._fx = None
        self._addr = 0
        try:
            from ..native import build as _nb

            lib = _nb.load()
            if lib is not None:
                self._fx = lib
                self._addr = _nb.buffer_address(self._mm)
        except Exception:
            self._fx = None

    # -- u64 accessors ------------------------------------------------------

    def _get(self, idx: int) -> int:
        return _U64.unpack_from(self._mm, 8 * idx)[0]

    def _set(self, idx: int, v: int):
        _U64.pack_into(self._mm, 8 * idx, v)

    def _set_wake(self, idx: int, v: int):
        """Release-store + wake futex sleepers on this word."""
        if self._fx is not None:
            self._fx.ca_store_u64_wake(self._addr + 8 * idx, v)
        else:
            self._set(idx, v)

    def _wait_ge(self, idx: int, min_val: int, deadline) -> None:
        """Block until word[idx] >= min_val, honoring close flag + deadline."""
        while True:
            if self._released:
                raise ChannelClosedError
            if self._get(idx) >= min_val:
                return
            if self._get(3) & _FLAG_CLOSED:
                raise ChannelClosedError
            if deadline is not None and _now() > deadline:
                raise TimeoutError("channel wait timed out")
            if self._fx is not None:
                # the C wait watches the close-flag word too, so a close()
                # wake that lands while the waiter is queued returns
                # immediately with rc=2; the 50ms slice bounds the rare lost
                # wake (flag set between the waiter's check and FUTEX_WAIT)
                slice_ns = 50_000_000
                if deadline is not None:
                    slice_ns = min(slice_ns, max(1, int((deadline - _now()) * 1e9)))
                self._fx.ca_wait_u64_ge_flag(
                    self._addr + 8 * idx,
                    min_val,
                    self._addr + 8 * 3,  # flags word
                    _FLAG_CLOSED,
                    slice_ns,
                )
            else:
                time.sleep(_POLL_S)

    def _init_header(self):
        self._set(0, _MAGIC)
        for i in range(1, 5 + self.num_readers):
            self._set(i, 0)
        self._set(4, self.num_readers)

    @property
    def version(self) -> int:
        return self._get(1)

    def spec(self) -> dict:
        return {"kind": "shm", "path": self.path, "num_readers": self.num_readers}

    @classmethod
    def open(cls, spec: dict, reader_index: int = 0) -> "ShmChannel":
        ch = cls(num_readers=spec["num_readers"], path=spec["path"])
        ch.reader_index = reader_index
        return ch

    # -- core protocol ------------------------------------------------------

    def _write_payload(self, chunks, total: int, spilled: bool, deadline):
        """chunks: list of bytes-like pieces written back-to-back (scatter
        write — large array buffers go straight from their source into shm
        with no intermediate contiguous blob)."""
        want = self.version
        for r in range(self.num_readers):
            if self._get(5 + r) < want:
                # a reader hasn't consumed the previous version yet: this
                # write is about to block on backpressure
                CHANNEL_STATS["backpressure_waits"] += 1
            self._wait_ge(5 + r, want, deadline)  # acks only ever increase
        pos = self.header_size
        for c in chunks:
            n = len(c)
            self._mm[pos : pos + n] = c
            pos += n
        self._set(2, total | (_SPILL_BIT if spilled else 0))
        self._set_wake(1, want + 1)  # publish + wake readers

    def _enter(self):
        """Mark this thread as touching the segment (native or mmap) so a
        concurrent release() cannot unmap under it; the whole read()/write()
        critical section is covered, not just the futex wait."""
        with self._waiters_lock:
            if self._released:
                raise ChannelClosedError
            self._waiters += 1

    def _exit(self):
        with self._waiters_lock:
            self._waiters -= 1

    def write(self, value: Any, timeout: Optional[float] = None):
        from ..core.serialization import pack, pack_chunks

        deadline = None if timeout is None else _now() + timeout
        total, chunks = pack_chunks(value)
        spilled = False
        ref = None
        if total > self.capacity:
            from ..core import api as ca

            ref = ca.put(value)
            payload = pack(ref)
            chunks, total, spilled = [payload], len(payload), True
            CHANNEL_STATS["spills"] += 1
        self._enter()
        try:
            self._write_payload(chunks, total, spilled, deadline)
        finally:
            self._exit()
        CHANNEL_STATS["writes"] += 1
        # _write_payload waited for all acks of the previous version, and
        # readers only ack after fetching a spilled payload — so the prior
        # spilled object (if any) has been consumed.  Drop its ref, and keep
        # the new one (None for inline writes) alive until the next write.
        self._last_spill = ref

    def read(self, timeout: Optional[float] = None) -> Any:
        from ..core.serialization import unpack

        deadline = None if timeout is None else _now() + timeout
        self._enter()
        try:
            my_ack = self._get(5 + self.reader_index)
            self._wait_ge(1, my_ack + 1, deadline)
            ver = self.version
            ln = self._get(2)
            spilled = bool(ln & _SPILL_BIT)
            ln &= ~_SPILL_BIT
            value = unpack(bytes(self._mm[self.header_size : self.header_size + ln]))
        finally:
            self._exit()
        if spilled:
            from ..core import api as ca

            # fetch BEFORE acking: the ack is what lets the writer's next
            # write drop its reference to this spilled object
            value = ca.get(value)
        try:
            self._enter()
            try:
                self._set_wake(5 + self.reader_index, ver)
            finally:
                self._exit()
        except ChannelClosedError:
            pass  # released mid-read: the ack is writer bookkeeping only —
            # the value was already read in full, so deliver it
        CHANNEL_STATS["reads"] += 1
        return value

    def wait_consumed(self, timeout: Optional[float] = None) -> bool:
        """Writer-side drain barrier: block until every reader has acked the
        last published version (i.e. the final write has been consumed), so
        release() can't unlink the segment under a reader that hasn't mapped
        or read it yet.  Returns False on timeout or close."""
        deadline = None if timeout is None else _now() + timeout
        want = self.version
        try:
            self._enter()
        except ChannelClosedError:
            return False
        try:
            for r in range(self.num_readers):
                self._wait_ge(5 + r, want, deadline)
            return True
        except (ChannelClosedError, TimeoutError):
            return False
        finally:
            self._exit()

    def close(self):
        try:
            self._enter()
        except ChannelClosedError:
            return  # already released locally; nothing to flag
        CHANNEL_STATS["closes"] += 1
        try:
            self._set(3, _FLAG_CLOSED)
            if self._fx is not None:
                # wake WITHOUT storing: a read-modify-store here could roll
                # back a concurrent publish/ack; sleepers re-check the flag
                self._fx.ca_wake_u64(self._addr + 8)
                for r in range(self.num_readers):
                    self._fx.ca_wake_u64(self._addr + 8 * (5 + r))
        finally:
            self._exit()

    def release(self):
        # flip the process-local flag, wake local sleepers, then wait for
        # every native waiter to leave the segment before unmapping (each
        # waiter's slice is <=50ms, so this drains quickly; cap at 2s so a
        # wedged waiter can't hang release forever — leaking the map is
        # better than a segfault)
        self._released = True
        if self._fx is not None and self._addr:
            try:
                self._fx.ca_wake_u64(self._addr + 8)
                for r in range(self.num_readers):
                    self._fx.ca_wake_u64(self._addr + 8 * (5 + r))
            except Exception:
                pass
        deadline = _now() + 2.0
        while self._waiters and _now() < deadline:
            time.sleep(0.001)
        if self._waiters:
            return  # leak the mapping rather than unmap under a waiter
        try:
            self._mm.close()
        except Exception:
            pass
        if self._created:
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def __reduce__(self):
        raise TypeError("ShmChannel is not serializable; pass spec() and open()")


class BufferedShmChannel(ChannelInterface):
    """N-slot channel for pipelined execution (reference:
    BufferedSharedMemoryChannel, shared_memory_channel.py:534).  Writer and
    each reader advance through slots round-robin, so up to N writes can be
    in flight before the writer blocks on reader acks."""

    def __init__(
        self,
        num_readers: int = 1,
        num_buffers: int = 2,
        buffer_size: int = _DEFAULT_BUFFER,
    ):
        self._chans = [ShmChannel(num_readers, buffer_size) for _ in range(num_buffers)]
        self._wseq = 0
        self._rseq = 0

    def spec(self) -> dict:
        return {"kind": "buffered", "specs": [c.spec() for c in self._chans]}

    @classmethod
    def open(cls, spec: dict, reader_index: int = 0) -> "BufferedShmChannel":
        ch = cls.__new__(cls)
        ch._chans = [ShmChannel.open(s, reader_index) for s in spec["specs"]]
        ch._wseq = 0
        ch._rseq = 0
        return ch

    def write(self, value: Any, timeout: Optional[float] = None):
        self._chans[self._wseq % len(self._chans)].write(value, timeout)
        self._wseq += 1

    def read(self, timeout: Optional[float] = None) -> Any:
        v = self._chans[self._rseq % len(self._chans)].read(timeout)
        self._rseq += 1
        return v

    def wait_consumed(self, timeout: Optional[float] = None) -> bool:
        deadline = None if timeout is None else _now() + timeout
        for c in self._chans:
            left = None if deadline is None else max(0.0, deadline - _now())
            if not c.wait_consumed(left):
                return False
        return True

    def close(self):
        for c in self._chans:
            c.close()

    def release(self):
        for c in self._chans:
            c.release()


def open_channel(spec: dict, reader_index: int = 0) -> ChannelInterface:
    if spec["kind"] == "shm":
        return ShmChannel.open(spec, reader_index)
    if spec["kind"] == "buffered":
        return BufferedShmChannel.open(spec, reader_index)
    raise ValueError(f"unknown channel kind {spec['kind']!r}")


class IntraProcessChannel(ChannelInterface):
    """Same-process channel (reference: intra_process_channel.py)."""

    def __init__(self, maxsize: int = 1):
        self._q: _queue.Queue = _queue.Queue(maxsize=maxsize)
        self._closed = False

    def write(self, value: Any, timeout: Optional[float] = None):
        if self._closed:
            raise ChannelClosedError
        self._q.put(value, timeout=timeout)

    def read(self, timeout: Optional[float] = None) -> Any:
        remaining = timeout
        while True:
            try:
                return self._q.get(timeout=0.05 if remaining is None else min(remaining, 0.05))
            except _queue.Empty:
                if self._closed:
                    raise ChannelClosedError from None
                if remaining is not None:
                    remaining -= 0.05
                    if remaining <= 0:
                        raise TimeoutError("channel read timed out") from None

    def close(self):
        self._closed = True


# NOTE: the reference also has a CompositeChannel (shared_memory_channel.py:648)
# that picks intra-process vs shm transport per reader.  Here actors and the
# driver are always separate processes, so shm is always the right transport
# and no composite selection layer exists; same-actor DAG edges pass values
# in-memory inside the actor loop instead (dag/compiled.py "local" arg specs).
