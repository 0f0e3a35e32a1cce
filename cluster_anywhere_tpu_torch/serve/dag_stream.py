"""Compiled-DAG stream plumbing for the serving plane.

The RPC streaming path moves every token through the worker's task-return
machinery: serialize -> stream_ack RPC -> driver inbox -> SSE writer.  On
the compiled path the replica pushes frames straight into a pre-opened
shared-memory channel and the proxy futex-waits on the header word -- no
per-token RPC at all.  Exactly one RPC remains per request: the handshake
(`dag_stream`) that submits the prompt and returns the channel spec.

Wire format rides on the shm channel frame (see channel/shm_channel.py):
each payload is one pickled event dict {"token_id": int, "text": str};
the stream terminates with the DAG_EOF sentinel string, or with one
{DAG_ERR: repr} dict if the engine died mid-decode.
"""

from typing import Optional

DAG_EOF = "__ca_dag_eof__"  # final frame: stream ended normally
DAG_ERR = "__ca_dag_err__"  # key of a terminal error frame: {DAG_ERR: repr}


class DagStreamReader:
    """Proxy-side endpoint of a replica's token channel.

    Iterates event dicts until the EOF/error frame.  Duck-types the two
    methods the SSE pump needs from a streaming ObjectRefGenerator --
    iteration and cancel() -- so the proxy's pump/abandonment machinery
    works unchanged on either path.
    """

    def __init__(self, spec: dict, timeout_s: float = 120.0):
        from ..channel.shm_channel import open_channel

        self._ch = open_channel(spec, 0)
        self._timeout = timeout_s

    def __iter__(self):
        try:
            while True:
                frame = self._ch.read(self._timeout)
                if frame == DAG_EOF:
                    return
                if isinstance(frame, dict) and DAG_ERR in frame:
                    raise RuntimeError(frame[DAG_ERR])
                yield frame
        finally:
            self.release()

    def cancel(self):
        """Abandonment: set the shared closed flag so the replica-side
        forwarder's next write raises ChannelClosedError and frees the
        decode slot (mirrors ObjectRefGenerator.cancel on the RPC path)."""
        try:
            self._ch.close()
        except Exception:
            pass

    def release(self):
        try:
            self._ch.release()
        except Exception:
            pass


def open_dag_stream(spec: dict, timeout_s: Optional[float] = None) -> DagStreamReader:
    return DagStreamReader(spec, 120.0 if timeout_s is None else timeout_s)
