"""Streaming generator returns (analogue of the reference's
ObjectRefGenerator, python/ray/_raylet.pyx:284, with producer-side
backpressure per src/ray/core_worker/generator_waiter.h).

A task or actor method submitted with num_returns="streaming" returns an
ObjectRefGenerator.  The executing worker streams each yielded item to the
submitter as it is produced ("stream_item" frames over the direct task
socket; items use the normal inline/shm result packaging), and the original
RPC reply doubles as the end-of-stream marker.  The producer BLOCKS once
more than `streaming_backpressure` items are unconsumed; the consumer acks
as it takes refs off the generator.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from .ids import ObjectID, TaskID


class StreamState:
    """Submitter-side state of one in-flight streaming task."""

    __slots__ = (
        "task_id", "addr", "produced", "next_read", "ended", "error", "cond",
    )

    def __init__(self, task_id: TaskID, addr: Optional[str] = None):
        self.task_id = task_id
        self.addr = addr  # executing worker (ack target), set at push time
        self.produced = 0
        self.next_read = 0
        self.ended = False
        self.error: Optional[BaseException] = None
        self.cond = threading.Condition()

    def on_item(self, idx: int):
        with self.cond:
            self.produced = max(self.produced, idx + 1)
            self.cond.notify_all()

    def on_end(self, error: Optional[BaseException] = None):
        with self.cond:
            self.ended = True
            self.error = error
            self.cond.notify_all()


class ObjectRefGenerator:
    """Iterator of ObjectRefs for a streaming task's yields.

    next() blocks until the next item has been produced (or the stream
    ended), returns its ObjectRef, and acks consumption so the producer's
    backpressure window advances.  The refs resolve through the normal
    get() machinery.
    """

    def __init__(self, worker, state: StreamState, owner: str):
        self._worker = worker
        self._state = state
        self._owner = owner

    def __iter__(self):
        return self

    def __next__(self):
        st = self._state
        with st.cond:
            while st.next_read >= st.produced and not st.ended:
                st.cond.wait()
            if st.next_read < st.produced:
                idx = st.next_read
                st.next_read += 1
            else:
                if st.error is not None:
                    raise st.error
                raise StopIteration
        self._worker.stream_ack(st)
        from .object_ref import ObjectRef

        oid = ObjectID.for_return(st.task_id, idx)
        return ObjectRef(oid, owner=self._owner, worker=self._worker)

    def completed(self) -> bool:
        with self._state.cond:
            return self._state.ended and self._state.next_read >= self._state.produced

    def cancel(self) -> None:
        """Abandon the stream: interrupt the producer (TaskCancelledError at
        its next bytecode boundary, the normal ca.cancel path) and end the
        local stream so blocked __next__ callers wake with the error.  A
        consumer that stops reading mid-stream MUST call this — otherwise
        the producer keeps generating until its backpressure window fills
        (serve SSE client-disconnect path).  Idempotent; safe from any
        thread."""
        from ..core.errors import TaskCancelledError

        st = self._state
        with st.cond:
            already = st.ended
        if not already:
            self._worker.cancel_stream(st)
            st.on_end(TaskCancelledError("stream abandoned by consumer"))
