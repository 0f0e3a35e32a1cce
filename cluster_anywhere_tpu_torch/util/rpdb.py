"""Distributed pdb: breakpoints inside remote tasks/actors.

Reference parity: ``python/ray/util/rpdb.py`` (set_trace opens a remote
pdb; active breakpoints register in the GCS KV; ``ray debug`` lists and
attaches) — here ``ca.util.set_trace()`` / ``ca debug``.

Mechanics: set_trace() binds a TCP listener in the worker, registers
{host, port, task, pid} under the ``__rpdb__`` KV namespace, and BLOCKS the
executing thread until a client attaches (or `timeout` passes — a forgotten
breakpoint must not wedge a production task forever).  ``ca debug`` lists
the namespace, dials the chosen breakpoint, and bridges the local terminal
to the remote Pdb over the socket.  post_mortem() does the same from an
exception handler (workerproc wires it behind CA_POST_MORTEM=1, the
RAY_DEBUG_POST_MORTEM analogue)."""

from __future__ import annotations

import json
import os
import pdb
import socket
import sys
import time
from typing import Any, Dict, List, Optional

_NS = "__rpdb__"


class _SockIO:
    """File-ish adapter bridging Pdb's stdin/stdout to a socket."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._rfile = sock.makefile("r", encoding="utf-8", newline="\n")
        self._wfile = sock.makefile("w", encoding="utf-8", newline="\n")

    def readline(self):
        return self._rfile.readline()

    def write(self, s):
        self._wfile.write(s)
        return len(s)

    def flush(self):
        try:
            self._wfile.flush()
        except OSError:
            pass

    def close(self):
        for f in (self._rfile, self._wfile):
            try:
                f.close()
            except OSError:
                pass


class RemotePdb(pdb.Pdb):
    """Pdb bound to an accepted TCP connection.  The session socket closes
    when the user continues or quits (persistent breakpoints across a
    continue are not supported — one attach, one session)."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._io = _SockIO(sock)
        super().__init__(stdin=self._io, stdout=self._io)
        self.use_rawinput = False
        self.prompt = "(ca-pdb) "

    def _close_session(self):
        try:
            self._io.close()
            self._sock.close()
        except OSError:
            pass

    def set_continue(self):
        super().set_continue()
        self._close_session()

    def set_quit(self):
        super().set_quit()
        self._close_session()


def _register(worker, key: str, meta: Dict[str, Any]):
    worker.head_call(
        "kv_put", ns=_NS, key=key, value=json.dumps(meta).encode()
    )


def _deregister(worker, key: str):
    try:
        worker.head_call("kv_del", ns=_NS, key=key)
    except Exception:
        pass


def _serve_breakpoint(frame, label: str, timeout: float, tb=None) -> None:
    """Bind, register, block for one attach, run Pdb on `frame`.

    With `tb` (post-mortem), the session runs Pdb.interaction on the
    traceback — pdb.post_mortem semantics: the prompt lands in the CRASH
    frame with its locals live, `up`/`down` walk the traceback, and no
    trace function is installed (the frames are already unwound, so
    set_trace would stop in framework internals instead)."""
    from ..core.worker import global_worker

    worker = global_worker()
    if worker is None:  # not in a cluster: plain local pdb
        if tb is not None:
            pdb.post_mortem(tb)
        else:
            pdb.Pdb().set_trace(frame)
        return
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("0.0.0.0", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    # advertised host: prefer the address the worker already advertises for
    # its TCP serving socket (chosen to be reachable across nodes); a bare
    # gethostbyname(gethostname()) resolves to 127.0.1.1 on common distro
    # /etc/hosts layouts and would send cross-node attaches to the wrong box
    host = None
    adv = getattr(worker, "serve_addr_tcp", None)
    if adv and adv.startswith("tcp:"):
        h = adv[4:].rsplit(":", 1)[0]
        if h and h not in ("0.0.0.0", "::"):
            host = h
    if not host:
        try:
            host = socket.gethostbyname(socket.gethostname())
        except OSError:
            host = "127.0.0.1"
    key = f"{worker.client_id}:{os.getpid()}:{port}"
    _register(
        worker,
        key,
        {
            "host": host or "127.0.0.1",
            "port": port,
            "pid": os.getpid(),
            "client_id": worker.client_id,
            "label": label,
            "ts": time.time(),
        },
    )
    srv.settimeout(timeout)
    try:
        conn, _ = srv.accept()
    except socket.timeout:
        print(
            f"[ca-pdb] breakpoint {label!r} timed out after {timeout}s with no "
            "debugger attached; continuing",
            file=sys.stderr,
        )
        return
    finally:
        _deregister(worker, key)
        srv.close()
    rpdb = RemotePdb(conn)
    rpdb._io.write(f"[ca-pdb] attached: {label}\n")
    rpdb._io.flush()
    if tb is not None:
        # post-mortem: interact on the traceback's frames; blocks until
        # continue/quit, then close the session ourselves (no trace
        # function was ever installed)
        try:
            rpdb.reset()
            rpdb.interaction(None, tb)
        finally:
            rpdb._close_session()
        return
    # live breakpoint: MUST be the tail call — set_trace installs the trace
    # function and returns; any statement after it would be the first thing
    # the debugger stops in (instead of the user's frame).  The session
    # socket closes via RemotePdb.set_continue/set_quit.
    rpdb.set_trace(frame)


def set_trace(timeout: float = 600.0):
    """Breakpoint inside a remote task/actor: blocks until `ca debug`
    attaches (or timeout).  Drop-in for pdb.set_trace()."""
    frame = sys._getframe().f_back
    label = f"{frame.f_code.co_filename}:{frame.f_lineno} ({frame.f_code.co_name})"
    _serve_breakpoint(frame, label, timeout)


def post_mortem(exc: Optional[BaseException] = None, timeout: float = 600.0):
    """Serve a post-mortem debugging session on the active exception's
    traceback (reference RAY_DEBUG_POST_MORTEM role)."""
    if exc is None:
        exc = sys.exc_info()[1]
    tb = exc.__traceback__ if exc is not None else None
    if tb is None:
        return
    inner = tb
    while inner.tb_next is not None:
        inner = inner.tb_next
    label = f"post-mortem {type(exc).__name__}: {exc}"
    _serve_breakpoint(inner.tb_frame, label, timeout, tb=tb)


# ----------------------------------------------------------------- CLI side


def list_breakpoints(worker) -> List[Dict[str, Any]]:
    keys = worker.head_call("kv_keys", ns=_NS).get("keys", [])
    out = []
    for k in keys:
        raw = worker.head_call("kv_get", ns=_NS, key=k).get("value")
        if raw:
            meta = json.loads(raw)
            meta["key"] = k
            out.append(meta)
    return sorted(out, key=lambda m: m.get("ts", 0))


def attach(host: str, port: int) -> int:
    """Bridge the local terminal to a remote Pdb session.  Returns exit
    status (0 = session ended)."""
    import threading

    sock = socket.create_connection((host, port), timeout=10)
    done = threading.Event()

    def pump_out():
        try:
            while True:
                data = sock.recv(4096)
                if not data:
                    break
                sys.stdout.write(data.decode(errors="replace"))
                sys.stdout.flush()
        except OSError:
            pass
        finally:
            done.set()

    t = threading.Thread(target=pump_out, daemon=True)
    t.start()
    try:
        while not done.is_set():
            line = sys.stdin.readline()
            if not line:
                if not sys.stdin.isatty():
                    # piped input exhausted: the commands are already in
                    # flight — drain the remote's replies until it closes
                    # the session, or closing now races away the output
                    done.wait(timeout=15)
                # interactive Ctrl-D: detach immediately
                break
            try:
                sock.sendall(line.encode())
            except OSError:
                break
    except KeyboardInterrupt:
        pass
    finally:
        try:
            sock.close()
        except OSError:
            pass
        done.wait(timeout=1)
    return 0
