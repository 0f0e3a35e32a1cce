"""The log plane: structured cluster-wide log capture, shipping and query
(analogue of the reference's per-worker stdout/stderr redirection +
log_monitor.py + `ray logs`).

Three stages, each crossing the process boundary in a different direction:

* **Capture** (this module + core/workerproc.py).  Every spawned process
  (worker, node agent, head) wraps its `sys.stdout`/`sys.stderr` in
  line-buffered `StreamCapture` writers.  Raw text still passes through to
  the original fd (so the plain `<wid>.log` files keep working, including
  for C-level writes and crash output); each COMPLETE line is additionally
  stamped with `(node_id, worker_id, pid, task_id/actor_id, task name,
  trace span, ts, stream)` — task/actor identity comes from the same ambient
  execution context tracing uses (`push_context` installed around task
  execution) — and appended as JSONL to a rotating per-process file
  `<session>/nodes/<node_id>/<proc>.jsonl` (size-capped, `.1` rollover).

* **Ship** (core/nodeagent.py `_log_ship_loop` -> core/head.py
  `_h_log_batch`/`_forward_logs` -> core/worker.py `_on_log_batch`).  Node
  agents tail their node's JSONL files with a `LogTailer` and batch records
  to the head over the existing envelope path (`log_batch` notifies); the
  head forwards them to every subscribed driver (`log_sub`), dropping —
  never backpressuring workers — when a subscriber's socket buffer is full
  (counted in head stats `log_lines_dropped`).  Drivers print remote lines
  prefixed `(name wid=... pid=... node=...)` with repeated-line dedup
  ("[repeated Nx]"); `init(log_to_driver=False)` opts out.

* **Query** (core/head.py `_h_log_fetch` -> nodeagent `log_read`).  The head
  resolves a worker/actor/task/node id to the owning node and proxies
  reads/tails from that node's agent, so `ca logs [--follow] [--tail N]`,
  `util.state.get_log`, and the dashboard `/api/logs` work across nodes with
  no shared filesystem.

Per-process counters live in `LOG_STATS` (same plain-int discipline as
protocol.WIRE_STATS) and ship as `ca_log_lines_total` / `ca_log_bytes_total`
/ `ca_log_dropped_total` via util/metrics.
"""

from __future__ import annotations

import contextvars
import io
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

# Per-process log-plane counters.  Plain ints in a module dict (GIL-atomic
# increments; the metrics flusher only reads) shipped as ca_log_* counters.
LOG_STATS: Dict[str, int] = {
    "lines_total": 0,    # complete lines captured by this process
    "bytes_total": 0,    # bytes of captured line text
    "dropped_total": 0,  # lines lost (ship failure, malformed tail reads)
}


def log_stats() -> Dict[str, int]:
    """Snapshot of this process's log-plane counters."""
    return dict(LOG_STATS)


# ambient log attribution for the currently-executing task/actor call:
# {"task": hex, "actor": hex|None, "name": str} — pushed by workerproc
# around every execution path (sync, streaming, async actor methods)
_log_ctx: "contextvars.ContextVar[Optional[Dict[str, Any]]]" = contextvars.ContextVar(
    "ca_log_ctx", default=None
)


def push_context(task: Optional[str] = None, actor: Optional[str] = None,
                 name: Optional[str] = None):
    """Install task/actor attribution for the executing thread/coroutine.
    Returns a token for `pop_context`."""
    return _log_ctx.set({"task": task, "actor": actor, "name": name})


def pop_context(token) -> None:
    _log_ctx.reset(token)


def node_log_dir(session_dir: str, node_id: str) -> str:
    """Where a node's structured per-process JSONL logs live.  Same directory
    the node's agent (or the head, for n0) already owns — the tailer and the
    `log_read` RPC only ever touch the LOCAL node's dir, so nothing in the
    plane assumes a shared filesystem."""
    return os.path.join(session_dir, "nodes", node_id)


class RotatingJsonlWriter:
    """Append-only JSONL sink with a size cap: when the file would exceed
    `max_bytes` it rolls to `<path>.1` (replacing any previous rollover) and
    starts fresh — two files bound the disk footprint per process."""

    def __init__(self, path: str, max_bytes: int = 1 << 20):
        self.path = path
        self.max_bytes = max(max_bytes, 4096)
        self._lock = threading.Lock()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "ab")

    def write_record(self, rec: dict) -> None:
        try:
            data = (json.dumps(rec, default=str) + "\n").encode("utf-8", "replace")
        except (TypeError, ValueError):
            LOG_STATS["dropped_total"] += 1
            return
        with self._lock:
            try:
                if self._f.tell() + len(data) > self.max_bytes:
                    self._rotate()
                self._f.write(data)
                self._f.flush()
            except OSError:
                LOG_STATS["dropped_total"] += 1

    def _rotate(self) -> None:
        self._f.close()
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass
        self._f = open(self.path, "ab")

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass


class StreamCapture(io.TextIOBase):
    """Line-buffered stdout/stderr wrapper: raw text passes through to the
    original stream (the fd-level `.log` redirect keeps seeing everything);
    each complete line is handed to `emit(stream_name, line)` for structured
    capture.  File-descriptor users (subprocess spawns, faulthandler) keep
    working via the delegated `fileno()`."""

    def __init__(self, orig, stream_name: str, emit: Callable[[str, str], None]):
        self._orig = orig
        self._name = stream_name
        self._emit = emit
        self._buf = ""
        self._lock = threading.Lock()

    def write(self, s) -> int:
        if not isinstance(s, str):
            s = str(s)
        try:
            self._orig.write(s)
        except (OSError, ValueError):
            pass
        lines = None
        with self._lock:
            self._buf += s
            if "\n" in self._buf:
                parts = self._buf.split("\n")
                self._buf = parts[-1]
                lines = parts[:-1]
        if lines:
            # flush the pass-through so the raw .log stays promptly readable
            # (non-tty stdout is block-buffered)
            try:
                self._orig.flush()
            except (OSError, ValueError):
                pass
            for line in lines:
                try:
                    self._emit(self._name, line)
                except Exception:
                    LOG_STATS["dropped_total"] += 1
        return len(s)

    def flush(self) -> None:
        try:
            self._orig.flush()
        except (OSError, ValueError):
            pass

    def fileno(self) -> int:
        return self._orig.fileno()

    def isatty(self) -> bool:
        try:
            return self._orig.isatty()
        except (OSError, ValueError):
            return False

    @property
    def encoding(self):
        return getattr(self._orig, "encoding", "utf-8")

    def writable(self) -> bool:
        return True


class CaptureSink:
    """Builds stamped records from captured lines and appends them to the
    rotating JSONL file; keeps a ring of recent lines so task failures can
    attach the last ~20 lines of output to the propagated error."""

    def __init__(self, writer: RotatingJsonlWriter, *, node_id: str,
                 proc_id: str, pid: Optional[int] = None):
        self.writer = writer
        self.node_id = node_id
        self.proc_id = proc_id
        self.pid = pid or os.getpid()
        self.recent: "deque[str]" = deque(maxlen=100)

    def emit(self, stream: str, line: str) -> None:
        if len(line) > 8192:
            line = line[:8192] + "...[truncated]"
        LOG_STATS["lines_total"] += 1
        LOG_STATS["bytes_total"] += len(line)
        self.recent.append(line)
        rec: Dict[str, Any] = {
            "ts": time.time(),
            "stream": stream,
            "line": line,
            "wid": self.proc_id,
            "node": self.node_id,
            "pid": self.pid,
        }
        ctx = _log_ctx.get()
        if ctx is not None:
            if ctx.get("task"):
                rec["task"] = ctx["task"]
            if ctx.get("actor"):
                rec["actor"] = ctx["actor"]
            if ctx.get("name"):
                rec["name"] = ctx["name"]
        try:
            from . import tracing

            tr = tracing.current()
            if tr is not None:
                rec["trace"] = {"tid": tr.get("tid"), "sid": tr.get("sid")}
        except Exception:
            pass
        self.writer.write_record(rec)


_installed_sink: Optional[CaptureSink] = None


def install_capture(session_dir: str, node_id: str, proc_id: str, *,
                    max_bytes: int = 1 << 20) -> Optional[CaptureSink]:
    """Idempotently wrap this process's stdout/stderr in stamping captures
    writing `<session>/nodes/<node_id>/<proc_id>.jsonl`.  Also arms the
    metrics flusher so ca_log_* counters ship once the process connects."""
    global _installed_sink
    if _installed_sink is not None:
        return _installed_sink
    try:
        path = os.path.join(node_log_dir(session_dir, node_id), f"{proc_id}.jsonl")
        writer = RotatingJsonlWriter(path, max_bytes=max_bytes)
        sink = CaptureSink(writer, node_id=node_id, proc_id=proc_id)
        sys.stdout = StreamCapture(sys.stdout, "stdout", sink.emit)
        sys.stderr = StreamCapture(sys.stderr, "stderr", sink.emit)
        _installed_sink = sink
    except Exception:
        return None  # capture is best-effort: a process must never die for it
    try:
        from . import metrics

        metrics._ensure_flusher()
    except Exception:
        pass
    return sink


def recent_lines(n: int = 20) -> List[str]:
    """The last `n` lines this process captured (for error attachment)."""
    if _installed_sink is None:
        return []
    return list(_installed_sink.recent)[-n:]


# ------------------------------------------------------------------ tailing


def tail_file(path: str, tail: int = 200, off: Optional[int] = None,
              max_read: int = 1 << 20) -> Tuple[str, int]:
    """Read a raw log file: with `off=None`, the last `tail` lines plus the
    end offset (the follow cursor); with an offset, everything from there to
    EOF (capped).  Raises FileNotFoundError when the log doesn't exist."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if off is None:
            start = max(0, size - max_read)
            f.seek(start)
            data = f.read(size - start)
            lines = data.decode("utf-8", "replace").splitlines()
            return "\n".join(lines[-tail:]), size
        off = min(off, size)
        f.seek(off)
        data = f.read(max_read)
        return data.decode("utf-8", "replace"), off + len(data)


class LogTailer:
    """Incremental tailer over a node's `*.jsonl` capture files: tracks a
    byte offset per file, reads only complete lines, and survives rotation
    by draining the remainder of the rolled `.1` file before restarting at
    offset 0.  The files themselves are the buffer — nothing is dropped on
    a slow tick except lines a rotation overwrote (counted)."""

    def __init__(self, directory: str, max_records: int = 500,
                 max_bytes: int = 256 << 10):
        self.dir = directory
        self.max_records = max_records
        self.max_bytes = max_bytes
        # per-file cursor: name -> [inode, offset].  The inode is the
        # rotation detector — a shrunken size alone misses a rotation whose
        # fresh file grew past the stored offset within one poll period.
        self._cursors: Dict[str, list] = {}

    def poll(self) -> List[dict]:
        out: List[dict] = []
        try:
            names = sorted(os.listdir(self.dir))
        except OSError:
            return out
        for fn in names:
            if not fn.endswith(".jsonl"):
                continue
            if len(out) >= self.max_records:
                break
            path = os.path.join(self.dir, fn)
            try:
                st = os.stat(path)
            except OSError:
                continue
            cur = self._cursors.get(fn)
            if cur is None:
                cur = self._cursors[fn] = [st.st_ino, 0]
            ino, off = cur
            if st.st_ino != ino or st.st_size < off:
                # rotated under us: drain what we hadn't read of the rolled
                # file, then restart at the fresh file's beginning.  A drain
                # cut short (unreadable .1, or it rotated again) is a real
                # loss — count it instead of pretending completeness.
                drained_to, prev = off, -1
                while drained_to != prev:  # .1 is capped at the rotate size
                    prev = drained_to
                    drained_to = self._read_into(path + ".1", drained_to, out,
                                                 budget_exempt=True)
                try:
                    if drained_to < os.path.getsize(path + ".1"):
                        LOG_STATS["dropped_total"] += 1
                except OSError:
                    LOG_STATS["dropped_total"] += 1
                cur[0], cur[1] = st.st_ino, 0
                off = 0
            if st.st_size > off:
                cur[1] = self._read_into(path, off, out)
        return out

    def _read_into(self, path: str, off: int, out: List[dict],
                   budget_exempt: bool = False) -> int:
        """Parse complete lines from `off`; returns the new offset.  The
        max_records budget leaves unread lines in place for the next poll;
        rotation drains are budget-exempt (their file is about to be
        forgotten, so 'later' doesn't exist for them)."""
        try:
            with open(path, "rb") as f:
                f.seek(off)
                data = f.read(self.max_bytes)
        except OSError:
            return off
        consumed = 0
        for raw in data.splitlines(True):
            if not raw.endswith(b"\n"):
                break  # partial tail: picked up next poll
            if not budget_exempt and len(out) >= self.max_records:
                break  # budget: the offset stays before this line
            consumed += len(raw)
            s = raw.strip()
            if not s:
                continue
            try:
                out.append(json.loads(s))
            except ValueError:
                LOG_STATS["dropped_total"] += 1
        return off + consumed


# ----------------------------------------------------------- driver printing


def format_prefix(rec: dict) -> str:
    """`(name wid=w0001 pid=1234 node=node1)` — the reference's
    `(task_name pid=..., ip=...)` attribution prefix."""
    name = rec.get("name") or rec.get("wid") or "?"
    parts = [str(name)]
    wid = rec.get("wid")
    if wid and wid != name:
        parts.append(f"wid={wid}")
    if rec.get("pid"):
        parts.append(f"pid={rec['pid']}")
    if rec.get("node"):
        parts.append(f"node={rec['node']}")
    return "(" + " ".join(parts) + ")"


class DriverLogPrinter:
    """Prints shipped log records on the driver with consecutive-duplicate
    dedup: the first occurrence prints immediately; when the run breaks, a
    single "[repeated Nx]" summary replaces the suppressed copies."""

    def __init__(self, out=None, err=None):
        self._out = out
        self._err = err
        self._last_key: Optional[tuple] = None
        self._last_rec: Optional[dict] = None
        self._repeats = 0

    def _stream_for(self, rec: dict):
        if rec.get("stream") == "stderr":
            return self._err if self._err is not None else sys.stderr
        return self._out if self._out is not None else sys.stdout

    def print_records(self, records) -> None:
        for rec in records:
            if not isinstance(rec, dict):
                continue
            self._one(rec)
        self.flush_repeats()

    def _one(self, rec: dict) -> None:
        line = rec.get("line", "")
        key = (rec.get("wid"), rec.get("stream"), line)
        if key == self._last_key:
            self._repeats += 1
            return
        self.flush_repeats()
        self._last_key = key
        self._last_rec = rec
        print(f"{format_prefix(rec)} {line}", file=self._stream_for(rec), flush=True)

    def flush_repeats(self) -> None:
        if self._repeats and self._last_rec is not None:
            print(
                f"{format_prefix(self._last_rec)} {self._last_rec.get('line', '')} "
                f"[repeated {self._repeats}x]",
                file=self._stream_for(self._last_rec),
                flush=True,
            )
        self._repeats = 0
