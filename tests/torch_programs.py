"""One program under each package, for the port's runtime parity tests
(not a test module).

`run_under_each_package(program, tmp)` runs `python -c program <package>
<scratch dir> <output path>` for the JAX package and then for the port,
one after the other, and returns {package: the object the program
pickled to its output path}, or {package: {"error": ...}} when it failed
or outlived `timeout`; `run_under_package(pkg, program, tmp)` runs it
under one.  A program that outlives it gets SIGTERM, which the
programs answer by shutting their clusters down, and is killed only after
`shutdown_wait` seconds.

Each program's sessions live under a root of their own
(CA_SESSION_DIR_ROOT, removed afterwards): a session that another test's
`address="auto"` could find, or that another test's sweep could reach,
would make the two tests' outcomes depend on each other.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("cluster_anywhere_tpu", "cluster_anywhere_tpu_torch")


def _session_root() -> str:
    """A fresh directory short enough for the Unix sockets of the sessions
    under it (a long temp dir falls back to /tmp, as the port's config
    does)."""
    root = tempfile.mkdtemp(prefix="ca_")
    if len(root) > 40:
        os.rmdir(root)
        root = tempfile.mkdtemp(prefix="ca_", dir="/tmp")
    return root


def run_under_package(pkg: str, program: str, tmp, timeout: float = 150,
                      shutdown_wait: float = 30, env=None):
    """`program` under one package: the object it pickled, or {"error": ...}."""
    root = _session_root()
    scratch = os.path.join(str(tmp), f"{pkg}_scratch")
    os.makedirs(scratch, exist_ok=True)
    path = os.path.join(str(tmp), pkg)
    env = dict(os.environ, **(env or {}), PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               CA_SESSION_DIR_ROOT=root)
    proc = subprocess.Popen([sys.executable, "-c", program, pkg, scratch, path], env=env,
                            cwd="/", stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        try:
            _, err = proc.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.terminate()
            try:
                proc.communicate(timeout=shutdown_wait)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.communicate()
            return {"error": f"the program did not finish in {timeout} s"}
        if proc.returncode != 0:
            return {"error": f"exit {proc.returncode}: {err[-3000:]}"}
        with open(path, "rb") as f:
            return pickle.load(f)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def run_under_each_package(program: str, tmp, timeout: float = 150,
                           shutdown_wait: float = 30) -> dict:
    return {pkg: run_under_package(pkg, program, tmp, timeout, shutdown_wait)
            for pkg in PACKAGES}
