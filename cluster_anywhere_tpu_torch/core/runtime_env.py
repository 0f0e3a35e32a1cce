"""Per-task/actor runtime environments (analogue of the reference's
python/ray/_private/runtime_env/ — env_vars, working_dir, py_modules plugins
with content-addressed packaging through the head KV, reference
_private/runtime_env/packaging.py).

Driver side: `prepare()` packages local dirs into zips stored in the head KV
under their content digest (uploaded once, cached by digest). Worker side:
`RuntimeEnvContext.apply()` materializes the env — extracts packages into a
per-session cache, sets env vars / sys.path / cwd — and restores afterwards
(pool workers are reused; actors apply permanently in their dedicated
process).
"""

from __future__ import annotations

import hashlib
import io
import os
import shutil
import sys
import uuid
import zipfile
from typing import Any, Dict, List, Optional

_PKG_NS = "__pkgs__"
_MAX_PKG_BYTES = 100 * 1024 * 1024

_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}


def validate(runtime_env: Dict[str, Any]):
    allowed = {"env_vars", "working_dir", "py_modules", "pip", "config"}
    unknown = set(runtime_env) - allowed
    if unknown:
        raise ValueError(f"unsupported runtime_env keys: {sorted(unknown)}")
    ev = runtime_env.get("env_vars")
    if ev is not None and not all(
        isinstance(k, str) and isinstance(v, str) for k, v in ev.items()
    ):
        raise ValueError("env_vars must be Dict[str, str]")
    if "pip" in runtime_env:
        normalize_pip_spec(runtime_env["pip"])  # raises on malformed specs


def normalize_pip_spec(spec: Any) -> Dict[str, Any]:
    """Accept the reference's pip forms — list of requirements, or
    {"packages": [...], "find_links": path} — normalized for this
    environment's OFFLINE install contract: pip always runs --no-index
    against a local wheel cache (find_links; default $CA_PIP_FIND_LINKS),
    mirroring _private/runtime_env/pip.py minus the network."""
    if isinstance(spec, (list, tuple)):
        spec = {"packages": list(spec)}
    if not isinstance(spec, dict) or not spec.get("packages"):
        raise ValueError(
            'runtime_env "pip" must be a list of requirements or '
            '{"packages": [...], "find_links": <local wheel dir>}'
        )
    pkgs = [str(p) for p in spec["packages"]]
    find_links = spec.get("find_links") or os.environ.get("CA_PIP_FIND_LINKS")
    if not find_links:
        raise ValueError(
            "offline pip installs need a local wheel cache: pass "
            '{"pip": {"packages": [...], "find_links": "/path/to/wheels"}} '
            "or set CA_PIP_FIND_LINKS"
        )
    return {"packages": pkgs, "find_links": os.path.abspath(find_links)}


def pip_env_hash(norm: Dict[str, Any]) -> str:
    """URI-cache key (uri_cache.py analogue): the env is content-addressed
    by its normalized spec, so identical specs share one installed dir."""
    blob = "\x00".join(sorted(norm["packages"])) + "\x01" + norm["find_links"]
    return hashlib.sha256(blob.encode()).hexdigest()[:24]


def _zip_dir(path: str, excludes: Optional[List[str]] = None) -> bytes:
    buf = io.BytesIO()
    excludes = excludes or []
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
            for fname in files:
                full = os.path.join(root, fname)
                rel = os.path.relpath(full, path)
                if any(rel.startswith(e) for e in excludes):
                    continue
                z.write(full, rel)
    data = buf.getvalue()
    if len(data) > _MAX_PKG_BYTES:
        raise ValueError(
            f"runtime_env package {path!r} is {len(data)} bytes (max {_MAX_PKG_BYTES})"
        )
    return data


def _upload_dir(worker, path: str, excludes=None) -> str:
    """Zip + store in head KV under content digest; returns the digest."""
    data = _zip_dir(os.path.abspath(path), excludes)
    digest = hashlib.sha256(data).hexdigest()[:24]
    # overwrite=False: content-addressed, first writer wins
    worker.head_call("kv_put", ns=_PKG_NS, key=digest, value=data, overwrite=False)
    return digest


def prepare(runtime_env: Optional[Dict[str, Any]], worker) -> Optional[Dict[str, Any]]:
    """Driver side: turn user runtime_env into its wire form."""
    if not runtime_env:
        return None
    validate(runtime_env)
    wire: Dict[str, Any] = {}
    if runtime_env.get("env_vars"):
        wire["env_vars"] = dict(runtime_env["env_vars"])
    wd = runtime_env.get("working_dir")
    if wd:
        if not os.path.isdir(wd):
            raise ValueError(f"working_dir {wd!r} is not a directory")
        excludes = (runtime_env.get("config") or {}).get("excludes")
        wire["working_dir_pkg"] = _upload_dir(worker, wd, excludes)
    mods = runtime_env.get("py_modules")
    if mods:
        pkgs = []
        for m in mods:
            if not os.path.isdir(m):
                raise ValueError(f"py_modules entry {m!r} is not a directory")
            pkgs.append((os.path.basename(os.path.abspath(m)), _upload_dir(worker, m)))
        wire["py_module_pkgs"] = pkgs
    if runtime_env.get("pip"):
        norm = normalize_pip_spec(runtime_env["pip"])
        if not os.path.isdir(norm["find_links"]):
            raise ValueError(f"pip find_links {norm['find_links']!r} is not a directory")
        norm["hash"] = pip_env_hash(norm)
        wire["pip"] = norm
    return wire or None


class RuntimeEnvContext:
    """Worker side: materialize and (optionally) roll back a runtime env."""

    def __init__(self, wire: Dict[str, Any], worker):
        self.wire = wire or {}
        self.worker = worker
        self._saved_env: Dict[str, Optional[str]] = {}
        self._saved_cwd: Optional[str] = None
        self._added_paths: List[str] = []

    def _materialize_pkg(self, digest: str) -> str:
        cache_root = os.path.join(self.worker.session_dir, "runtime_env_cache")
        dest = os.path.join(cache_root, digest)
        if os.path.isdir(dest):
            return dest
        reply = self.worker.head_call("kv_get", ns=_PKG_NS, key=digest)
        data = reply.get("value")
        if data is None:
            raise RuntimeError(f"runtime_env package {digest} missing from cluster KV")
        os.makedirs(cache_root, exist_ok=True)
        # pid alone is not unique: two executor threads in one worker (actor
        # max_concurrency / concurrency groups) applying the same spec would
        # interleave into a shared tmp and poison the cache for the session
        tmp = dest + f".tmp{os.getpid()}.{uuid.uuid4().hex[:8]}"
        with zipfile.ZipFile(io.BytesIO(data)) as z:
            z.extractall(tmp)
        try:
            os.rename(tmp, dest)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)  # concurrent extract won
        return dest

    def _materialize_pip(self, norm: Dict[str, Any]) -> str:
        """Install the pip env into a spec-hash-keyed cache dir (once per
        session per spec) and return it.  Strictly offline: --no-index with
        the given local wheel cache.  Installs land in a tmp dir renamed
        atomically, so concurrent workers race safely and a crashed install
        never half-populates the cache."""
        import subprocess

        dest = os.path.join(
            self.worker.session_dir, "runtime_env_cache", "pip_" + norm["hash"]
        )
        if os.path.isdir(dest):
            return dest
        os.makedirs(os.path.dirname(dest), exist_ok=True)
        tmp = dest + f".tmp{os.getpid()}.{uuid.uuid4().hex[:8]}"
        cmd = [
            sys.executable, "-m", "pip", "install", "--quiet",
            "--no-index", "--find-links", norm["find_links"],
            "--target", tmp, "--no-warn-script-location",
            *norm["packages"],
        ]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except subprocess.TimeoutExpired:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(
                f"offline pip install failed ({' '.join(norm['packages'])}): "
                f"timed out after 300s"
            )
        if r.returncode != 0:
            shutil.rmtree(tmp, ignore_errors=True)
            raise RuntimeError(
                f"offline pip install failed ({' '.join(norm['packages'])}): "
                f"{r.stderr.strip()[-500:]}"
            )
        try:
            os.rename(tmp, dest)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)  # concurrent install won
        return dest

    def apply(self):
        for k, v in (self.wire.get("env_vars") or {}).items():
            self._saved_env[k] = os.environ.get(k)
            os.environ[k] = v
        pip_spec = self.wire.get("pip")
        if pip_spec:
            path = self._materialize_pip(pip_spec)
            sys.path.insert(0, path)
            self._added_paths.append(path)
        pkg = self.wire.get("working_dir_pkg")
        if pkg:
            path = self._materialize_pkg(pkg)
            self._saved_cwd = os.getcwd()
            os.chdir(path)
            sys.path.insert(0, path)
            self._added_paths.append(path)
        for _name, digest in self.wire.get("py_module_pkgs") or []:
            path = self._materialize_pkg(digest)
            # the zip contains the module dir's *contents*; import must see the
            # module by name, so expose the parent with a named symlink
            parent = path + "_mods"
            os.makedirs(parent, exist_ok=True)
            link = os.path.join(parent, _name)
            if not os.path.exists(link):
                try:
                    os.symlink(path, link)
                except FileExistsError:
                    pass
            sys.path.insert(0, parent)
            self._added_paths.append(parent)

    def restore(self):
        for k, old in self._saved_env.items():
            if old is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = old
        self._saved_env.clear()
        if self._saved_cwd is not None:
            try:
                os.chdir(self._saved_cwd)
            except OSError:
                pass
            self._saved_cwd = None
        for p in self._added_paths:
            try:
                sys.path.remove(p)
            except ValueError:
                pass
            # pool workers are reused: a module cached in sys.modules would
            # leak this env's code into later tasks even after the path is
            # gone, so evict everything imported from under the env dir —
            # including namespace packages, whose __file__ is None but whose
            # __path__ points into it
            prefix = p + os.sep
            for name, mod in list(sys.modules.items()):
                f = getattr(mod, "__file__", None)
                if f and (f.startswith(prefix) or f == p):
                    del sys.modules[name]
                    continue
                try:
                    paths = list(getattr(mod, "__path__", None) or [])
                except Exception:
                    continue
                if any(x == p or str(x).startswith(prefix) for x in paths):
                    del sys.modules[name]
        self._added_paths.clear()

    def __enter__(self):
        self.apply()
        return self

    def __exit__(self, *exc):
        self.restore()
        return False
