"""The port's static analyzer (cluster_anywhere_tpu_torch.analysis, `ca
lint`) against the JAX package's, on the CPU.

- Every fixture case of tests/test_lint.py (RPC contract, asyncio hazards,
  resource lifetimes, unbounded awaits, cancellation hygiene, pragmas,
  parse errors) runs through both analyzers, each fixture written at its
  own package's surface paths.  The findings must have equal rules,
  lines and contexts, equal messages and fingerprints once the package
  names are normalised (a fingerprint hashes the file's path), and the
  same suppressed count.  The scenarios of several steps (baselines,
  line drift, the CLI's exit codes, `--changed`) run under both and give
  equal results.
- The port over this checkout: the same rules as the JAX analyzer, a clean
  run with an empty baseline, a contract that covers every `_h_*` handler
  of its head, a committed contract (docs/PROTOCOL_CONTRACT_TORCH.json)
  that is fresh and names the JAX contract's methods plus the port's
  `release_device`, and `ca lint --contract` writing none of the JAX
  package's files.
- The repaired chaos-spec check: a misspelled method raises in both
  packages, and neither checks without a contract.
"""

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import textwrap

import pytest

from cluster_anywhere_tpu.analysis import engine as jengine
from cluster_anywhere_tpu.analysis import lint as jlint
from cluster_anywhere_tpu_torch.analysis import contract as tcontract
from cluster_anywhere_tpu_torch.analysis import engine as tengine
from cluster_anywhere_tpu_torch.analysis import lint as tlint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX, PORT = "cluster_anywhere_tpu", "cluster_anywhere_tpu_torch"
ANALYZERS = {JAX: (jengine, jlint), PORT: (tengine, tlint)}


def norm(text):
    """A package's name replaced by PKG (the port's first: it starts with
    the JAX package's)."""
    return text.replace(PORT, "PKG").replace(JAX, "PKG")


def normalised(finding):
    """A finding with its package names normalised, and the fingerprint of
    the finding so normalised."""
    same = tengine.Finding(rule=finding.rule, file=norm(finding.file), line=finding.line,
                           context=norm(finding.context), message=norm(finding.message),
                           detail=norm(finding.detail))
    return (same.rule, same.file, same.line, same.context, same.message, same.fingerprint)


def write(root, files, pkg):
    for rel, src in files.items():
        p = root / rel.format(pkg=pkg)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src.format(pkg=pkg)))


def lint_each(tmp_path, files, passes):
    """{package: (normalised findings, suppressed, ok)}, each package's
    analyzer over the fixture written at its own paths."""
    out = {}
    for pkg, (engine, _) in ANALYZERS.items():
        root = tmp_path / pkg
        write(root, files, pkg)
        report = engine.run_lint(root=str(root), passes=passes,
                                 baseline_file=str(root / "baseline.json"))
        out[pkg] = ([normalised(f) for f in report["findings"]], report["suppressed"],
                    report["ok"])
    return out


HEAD = "{pkg}/core/head.py"
AGENT = "{pkg}/core/nodeagent.py"
WORKER = "{pkg}/core/worker.py"
MOD = "{pkg}/mod.py"


def _fixture(src):
    """A fixture's source with the braces that str.format would read
    doubled, the {pkg} placeholder kept."""
    return src.replace("{", "{{").replace("}", "}}").replace("{{pkg}}", "{pkg}")


def _res(body):
    return {MOD: "import os\nimport asyncio\n" + textwrap.dedent(body)}


# (name, files, passes, the rules and contexts tests/test_lint.py expects of
# the case: sorted (rule, context) pairs of the findings)
CASES = [
    ("rpc-unknown-method", {
        HEAD: """
            class Head:
                async def _h_foo(self, state, msg, reply, reply_err):
                    reply(v=msg["x"])
            """,
        WORKER: """
            async def caller(conn):
                await conn.call("fooo", x=1)   # typo'd
                await conn.call("foo", x=1)    # fine (also keeps foo alive)
            """,
    }, ("rpc",), [("rpc-unknown-method", "caller")]),
    ("rpc-dead-handler", {
        HEAD: """
            class Head:
                async def _h_used(self, state, msg, reply, reply_err):
                    reply()
                async def _h_orphan(self, state, msg, reply, reply_err):
                    reply()
            """,
        WORKER: "async def c(conn):\n    await conn.call('used')\n",
    }, ("rpc",), [("rpc-dead-handler", "Head._h_orphan")]),
    ("rpc-missing-field", {
        HEAD: """
            class Head:
                async def _h_put(self, state, msg, reply, reply_err):
                    key = msg["key"]            # hard requirement
                    if msg.get("versioned"):
                        old = msg["version"]    # branch-only: NOT required
                    reply(k=key)
            """,
        WORKER: """
            async def c(conn):
                await conn.call("put", versioned=True)  # missing key only
            """,
    }, ("rpc",), [("rpc-missing-field", "c")]),
    ("rpc-unread-field", {
        HEAD: """
            class Head:
                async def _h_closed(self, state, msg, reply, reply_err):
                    reply(v=msg["x"])
                async def _h_open(self, state, msg, reply, reply_err):
                    self.queue.append(msg)   # msg escapes: reads unknowable
                    reply()
            """,
        WORKER: """
            async def c(conn):
                await conn.call("closed", x=1, stray=2)
                await conn.call("open", anything=3)
            """,
    }, ("rpc",), [("rpc-unread-field", "c")]),
    ("rpc-chain-surface", {
        AGENT: """
            class NodeAgent:
                async def _handle(self, state, msg, reply, reply_err):
                    m = msg["m"]
                    if m == "alpha":
                        reply(v=msg["a"])
                    elif m in ("beta", "gamma"):
                        reply(v=msg.get("b"))
                    else:
                        reply_err(ValueError(m))
            """,
        WORKER: """
            class Worker:
                async def _on_push(self, msg):
                    if msg.get("m") != "pub":
                        return
                    ch = msg.get("ch")

            async def c(conn, fields):
                await conn.call("alpha", a=1)
                conn.notify("beta", **fields)   # dynamic: method check only
                conn.notify("gamma", b=2)
                conn.notify("pub", ch="x")
            """,
    }, ("rpc",), []),
    ("rpc-spec-dict-and-wrapper", {
        HEAD: """
            class Head:
                async def _h_evt(self, state, msg, reply, reply_err):
                    reply(v=msg["seq"])
                async def _h_listed(self, state, msg, reply, reply_err):
                    reply(n=msg.get("limit"))
            """,
        WORKER: """
            def push(writer, write_frame):
                write_frame(writer, {"m": "evt", "seq": 7})

            def state_api(_head):
                return _head("listed", limit=5)
            """,
    }, ("rpc",), []),
    ("async-blocking-call", {MOD: """
            import asyncio, time, subprocess

            async def bad(fut, proc):
                time.sleep(1)
                subprocess.run(["true"])
                fut.result()
                proc.wait()

            async def good(ev):
                await asyncio.sleep(0)
                await ev.wait()          # awaited: the async dual

            def sync_ok():
                time.sleep(0.01)         # not on the loop
            """}, ("async",), [("async-blocking-call", "bad")] * 4),
    ("async-dropped-task", {MOD: """
            import asyncio
            from {pkg}.util.aio import spawn_logged

            async def bad(coro):
                asyncio.ensure_future(coro)          # dropped

            def also_bad(loop, coro):
                loop.create_task(coro)               # dropped, sync caller

            async def good(coro):
                t = asyncio.ensure_future(coro)      # held
                spawn_logged(coro, "named")          # guarded wrapper
                return t
            """}, ("async",), [("async-dropped-task", "also_bad"), ("async-dropped-task", "bad")]),
    ("async-await-race", {MOD: """
            class S:
                async def carried(self):
                    n = self.count
                    await self.flush()
                    self.count = n + 1          # stale n

                async def in_statement(self):
                    self.total = self.total + await self.price()

                async def augmented(self):
                    self.total += await self.price()

                async def fine(self):
                    self.addr = await self.dial()   # plain overwrite
                    self.count += 1                 # atomic RMW, no yield
                    n = self.count
                    self.count = n + 1              # no await between
            """}, ("async",), [("async-await-race", "S.augmented"),
                               ("async-await-race", "S.carried"),
                               ("async-await-race", "S.in_statement")]),
    ("res-shm-channel", _res("""
        def leaky(spec, flag):
            ch = open_channel(spec, 0)
            if flag:
                return None         # early exit with the segment mapped
            ch.release()
            return True

        def leaky_ctor(n):
            ch = BufferedShmChannel(num_readers=n)
            return None             # dropped without release

        def clean(spec):
            ch = open_channel(spec, 0)
            try:
                return ch.read(1.0)
            finally:
                ch.release()
        """), ("res",), None),
    ("res-leak-on-raise", _res("""
        def leaky(p):
            fd = os.open(p, 0)
            data = os.read(fd, 1)    # may raise while fd is held
            os.close(fd)
            return data

        def clean(p):
            fd = os.open(p, 0)
            try:
                data = os.read(fd, 1)
            finally:
                os.close(fd)
            return data
        """), ("res",), [("res-leak-on-raise", "leaky")]),
    ("res-leak-on-return", _res("""
        def leaky(p, flag):
            fd = os.open(p, 0)
            if flag:
                return None          # fd still open
            os.close(fd)
            return fd

        def clean(p, flag):
            fd = os.open(p, 0)
            if flag:
                os.close(fd)
                return None
            os.close(fd)
            return fd
        """), ("res",), None),
    ("res-double-release", _res("""
        def double(p):
            fd = os.open(p, 0)
            os.close(fd)
            os.close(fd)             # may already be released

        def clean(p, flag):
            fd = os.open(p, 0)
            if flag:
                os.close(fd)
                return
            os.close(fd)
        """), ("res",), None),
    ("res-loop-carried", _res("""
        def leaky(ps):
            for p in ps:
                fd = os.open(p, 0)
                os.write(fd, b"x")
            os.close(fd)             # only the LAST iteration's fd

        def clean(ps):
            for p in ps:
                fd = os.open(p, 0)
                os.close(fd)
        """), ("res",), None),
    ("res-with-escape-guard", _res("""
        def managed(p):
            with open(p) as fh:      # structural release
                return fh.read()

        class C:
            async def kept(self, addr):
                conn = await connect_addr(addr)
                self._conns[addr] = conn   # escapes: not this fn's leak
                return conn

        def guarded(p, flag):
            fd = None
            if flag:
                fd = os.open(p, 0)
            if fd is not None:       # narrowing: the None arm holds nothing
                os.close(fd)
        """), ("res",), []),
    ("res-lock-and-stream", _res("""
        async def lock_leak(lk, q):
            lk.acquire()
            await q.get()            # raise path leaves lk held
            lk.release()

        def lock_clean(lk, work):
            lk.acquire()
            try:
                work()
            finally:
                lk.release()

        async def stream_leak(host):
            r, w = await asyncio.open_connection(host, 1)
            data = await r.readexactly(4)
            w.close()
            return data
        """), ("res",), None),
    ("async-unbounded-io", {MOD: """
            import asyncio
            from {pkg}.util import aio

            async def bad_dial(host):
                r, w = await asyncio.open_connection(host, 1)

            async def bad_drain(writer):
                await writer.drain()

            async def bad_read(reader):
                return await reader.readline()

            async def wrapped(host):
                r, w = await asyncio.wait_for(
                    asyncio.open_connection(host, 1), 5)

            async def helper(addr):
                return await aio.dial(addr)

            async def kwarg(addr):
                return await aio.dial(addr, timeout=2)

            async def ctx_block(writer):
                async with asyncio.timeout(5):
                    await writer.drain()
            """}, ("await",), [("async-unbounded-io", "bad_dial"),
                               ("async-unbounded-io", "bad_drain"),
                               ("async-unbounded-io", "bad_read")]),
    ("async-swallowed-cancel", {MOD: """
            import asyncio

            async def swallow(q):
                try:
                    await q.get()
                except Exception:
                    pass

            async def swallow_bare(q):
                try:
                    await q.get()
                except:
                    pass

            async def swallow_explicit(q):
                try:
                    await q.get()
                except asyncio.CancelledError:
                    pass

            async def safe_first(q):
                try:
                    await q.get()
                except asyncio.CancelledError:
                    raise
                except Exception:
                    pass

            async def safe_reraise(q, log):
                try:
                    await q.get()
                except Exception:
                    log()
                    raise

            async def safe_narrow(q):
                try:
                    await q.get()
                except ConnectionError:
                    pass

            def sync_ok(q):
                try:
                    q.get()
                except Exception:
                    pass
            """}, ("cancel",), [("async-swallowed-cancel", "swallow"),
                                ("async-swallowed-cancel", "swallow_bare"),
                                ("async-swallowed-cancel", "swallow_explicit")]),
    ("async-swallowed-cancel-past-reraise", {MOD: """
            import asyncio

            async def sneaky(q, log, store):
                try:
                    await q.get()
                except Exception:
                    log()
                    raise
                except BaseException as e:
                    store(e)
            """}, ("cancel",), [("async-swallowed-cancel", "sneaky")]),
    ("finally-await", {MOD: """
            from {pkg}.util.aio import finally_await

            async def masks(q, conn):
                try:
                    await q.get()
                finally:
                    await conn.close()

            async def safe(q, conn):
                try:
                    await q.get()
                finally:
                    await finally_await(conn.close(), "close")
            """}, ("cancel",), [("finally-await", "masks")]),
    ("pragma-suppression", {HEAD: """
            class Head:
                # ca-lint: ignore[rpc-dead-handler]
                async def _h_probe(self, state, msg, reply, reply_err):
                    reply()
                async def _h_dead(self, state, msg, reply, reply_err):  # ca-lint: ignore
                    reply()
                # ca-lint: ignore[rpc-unknown-method]
                async def _h_wrong_rule(self, state, msg, reply, reply_err):
                    reply()
            """}, ("rpc",), [("rpc-dead-handler", "Head._h_wrong_rule")]),
    ("pragma-decorated-def", {HEAD: """
            def deco(fn):
                return fn

            class Head:
                # ca-lint: ignore[rpc-dead-handler]
                @deco
                @deco
                async def _h_probe(self, state, msg, reply, reply_err):
                    reply()
                @deco
                async def _h_dead(self, state, msg, reply, reply_err):
                    reply()
            """}, ("rpc",), [("rpc-dead-handler", "Head._h_dead")]),
    ("pragma-nested-def", {MOD: """
            import asyncio

            def outer(coro, coro2):
                def inner():
                    asyncio.ensure_future(coro)  # ca-lint: ignore[async-dropped-task]
                def inner2():
                    asyncio.ensure_future(coro2)
                return inner, inner2
            """}, ("async",), [("async-dropped-task", "outer.inner2")]),
    ("parse-error-package", {"{pkg}/broken.py": "def broken(:\n"}, ("rpc", "async"),
     [("parse-error", "PKG/broken.py")]),
    ("parse-error-script", {"scripts/torch_broken.py": "def broken(:\n"}, ("rpc", "async"),
     [("parse-error", "scripts/torch_broken.py")]),
]
CASES = [(name, {rel: _fixture(src) for rel, src in files.items()}, passes, want)
         for name, files, passes, want in CASES]


@pytest.mark.parametrize("name, files, passes, want", CASES, ids=[c[0] for c in CASES])
def test_fixture_case_matches_jax(tmp_path, name, files, passes, want):
    got = lint_each(tmp_path, files, passes)
    assert got[PORT] == got[JAX]
    findings = got[PORT][0]
    if want is not None:  # the rule and context tests/test_lint.py checks
        assert sorted((rule, ctx) for rule, _, _, ctx, _, _ in findings) == sorted(want)
    else:  # each leaky function flagged, every clean one not
        contexts = {ctx for _, _, _, ctx, _, _ in findings}
        assert contexts and "clean" not in contexts and "lock_clean" not in contexts


# ----------------------------------------------------- scenarios of several steps


def _leak_src(name):
    return f"""
        import os

        def {name}(p):
            fd = os.open(p, 0)
            os.read(fd, 1)
            os.close(fd)
        """


def scenario_finally_await_fingerprint(root, pkg, engine, lint_main):
    src = """
        async def f(q, conn, log):
            try:
                await q.get()
            finally:
                {extra}await conn.close()
        """
    mod = root / pkg / "mod.py"
    mod.parent.mkdir(parents=True)
    fps = []
    for extra in ("", "log()\n                "):
        mod.write_text(textwrap.dedent(src.format(extra=extra)))
        report = engine.run_lint(root=str(root), passes=("cancel",),
                                 baseline_file=str(root / "baseline.json"))
        fps.append([normalised(f)[-1] for f in report["findings"] if f.rule == "finally-await"])
    assert fps[0] and fps[0] == fps[1]
    return fps


def scenario_baseline_round_trip(root, pkg, engine, lint_main):
    head = root / pkg / "core" / "head.py"
    head.parent.mkdir(parents=True)
    head.write_text("class Head:\n    async def _h_orphan(self, state, msg, reply, reply_err):\n"
                    "        reply()\n")
    baseline = root / "baseline.json"
    steps = []

    def run():
        r = engine.run_lint(root=str(root), passes=("rpc",), baseline_file=str(baseline))
        steps.append((r["ok"], len(r["new"]), len(r["stale"])))
        return r

    report = run()
    engine.save_baseline(str(baseline), report["findings"])
    run()
    head.write_text("class Head:\n    pass\n")
    report = run()
    engine.save_baseline(str(baseline), report["findings"])
    steps.append(json.loads(baseline.read_text())["findings"])
    assert steps == [(False, 1, 0), (True, 0, 0), (False, 0, 1), []]
    return steps


def scenario_line_drift(root, pkg, engine, lint_main):
    head = root / pkg / "core" / "head.py"
    head.parent.mkdir(parents=True)
    src = "class Head:\n    async def _h_orphan(self, state, msg, reply, reply_err):\n        reply()\n"
    out = []
    for text in (src, "# a comment\n# another\n" + src):
        head.write_text(text)
        report = engine.run_lint(root=str(root), passes=("rpc",),
                                 baseline_file=str(root / "baseline.json"))
        out.append([(normalised(f)[-1], f.line) for f in report["findings"]])
    assert out[0][0][0] == out[1][0][0] and out[0][0][1] != out[1][0][1]
    return out


def _cli(lint_main, argv):
    """The exit code and the output, package names normalised and each
    fingerprint masked (a fingerprint hashes the package's path; the cases
    above compare the normalised ones)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = lint_main(argv)
    return rc, re.sub(r"\b[0-9a-f]{16}\b", "<fingerprint>", norm(buf.getvalue()))


def scenario_baseline_growth_and_stale_exit(root, pkg, engine, lint_main):
    head = root / pkg / "core" / "head.py"
    head.parent.mkdir(parents=True)
    head.write_text("class Head:\n    async def _h_orphan(self, state, msg, reply, reply_err):\n"
                    "        reply()\n")
    common = ["--root", str(root), "--baseline", str(root / "baseline.json")]
    steps = [_cli(lint_main, common + ["--update-baseline"])]
    head.write_text("class Head:\n    pass\n")
    steps.append(_cli(lint_main, common))
    steps.append(_cli(lint_main, common + ["--update-baseline"]))
    steps.append(_cli(lint_main, common))
    assert [rc for rc, _ in steps] == [0, 1, 0, 0]
    assert "GREW" in steps[0][1] and "STALE" in steps[1][1] and "GREW" not in steps[2][1]
    return [(rc, out.replace(str(root), "ROOT")) for rc, out in steps]


def scenario_cli_json_and_exit_codes(root, pkg, engine, lint_main):
    (root / pkg).mkdir(parents=True)
    (root / pkg / "mod.py").write_text(textwrap.dedent(_leak_src("leaky")))
    common = ["--root", str(root), "--baseline", str(root / "b.json")]
    rc, out = _cli(lint_main, common + ["--format", "json"])
    report = json.loads(out)
    assert rc == 1 and not report["ok"] and report["counts"] == {"res-leak-on-raise": 1}
    steps = [(rc, report)]
    steps.append(_cli(lint_main, common + ["--update-baseline"])[0])
    rc, out = _cli(lint_main, common)
    assert rc == 0 and "clean" in out
    steps.append((rc, out))
    return steps


def scenario_changed_mode(root, pkg, engine, lint_main):
    env = dict(os.environ, GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t",
               GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@t")

    def git(*args):
        subprocess.run(("git", "-C", str(root)) + args, check=True, capture_output=True,
                       env=env, timeout=60)

    (root / pkg).mkdir(parents=True)
    (root / pkg / "old.py").write_text(textwrap.dedent(_leak_src("old_leak")))
    git("init", "-q", "-b", "main")
    git("add", "-A")
    git("commit", "-q", "-m", "seed")
    common = ["--root", str(root), "--baseline", str(root / "b.json"), "--changed",
              "--format", "json"]
    rc, out = _cli(lint_main, common)
    steps = [(rc, json.loads(out)["findings"])]
    (root / pkg / "new.py").write_text(textwrap.dedent(_leak_src("new_leak")))
    rc, out = _cli(lint_main, common)
    report = json.loads(out)
    steps.append((rc, [(f["rule"], f["file"], f["context"]) for f in report["findings"]]))
    assert steps == [(0, []), (1, [("res-leak-on-raise", "PKG/new.py", "new_leak")])]
    return steps


SCENARIOS = [scenario_finally_await_fingerprint, scenario_baseline_round_trip,
             scenario_line_drift, scenario_baseline_growth_and_stale_exit,
             scenario_cli_json_and_exit_codes, scenario_changed_mode]


@pytest.mark.parametrize("scenario", SCENARIOS, ids=[s.__name__[len("scenario_"):]
                                                     for s in SCENARIOS])
def test_scenario_matches_jax(tmp_path, scenario):
    if scenario is scenario_changed_mode and shutil.which("git") is None:
        pytest.fail("the --changed scenario needs git")
    got = {}
    for pkg, (engine, lint) in ANALYZERS.items():
        root = tmp_path / pkg
        root.mkdir()
        got[pkg] = scenario(root, pkg, engine, lint.main)
    assert got[PORT] == got[JAX]


def test_unknown_pass_is_refused(tmp_path):
    for engine, _ in ANALYZERS.values():
        with pytest.raises(ValueError, match="unknown lint pass"):
            engine.run_lint(root=str(tmp_path), passes=("resx",),
                            baseline_file=str(tmp_path / "b.json"))


# ------------------------------------------------------------- over this checkout


def test_rules_equal_jax():
    assert tengine.all_rules() == jengine.all_rules()
    assert sum(map(len, tengine.all_rules().values())) == 14


def test_port_scans_its_own_code_only():
    rels = {sf.relpath for sf in tengine.collect_files(REPO)}
    assert "cluster_anywhere_tpu_torch/core/head.py" in rels
    assert all(r.startswith("cluster_anywhere_tpu_torch/") or re.fullmatch(r"scripts/torch_\w+\.py", r)
               for r in rels), sorted(r for r in rels if not r.startswith(PORT))
    assert any(r.startswith("scripts/torch_") for r in rels)


def test_self_check_port_is_clean():
    """The port's analyzer over this checkout: no finding outside its
    (empty) baseline and no stale entry."""
    report = tengine.run_lint(root=REPO)
    with open(tengine.baseline_path(REPO)) as f:
        assert json.load(f)["findings"] == []
    assert report["ok"], [f.render() for f in report["new"]][:10]
    assert report["findings"] == []


def test_port_contract_covers_every_head_handler():
    c = tcontract.extract_contract(tengine.collect_files(REPO))
    head = {h.method for h in c.handlers if h.surface == "head"}
    with open(os.path.join(REPO, PORT, "core", "head.py")) as f:
        assert head == set(re.findall(r"async def _h_(\w+)\(", f.read()))
    assert len(head) >= 55
    worker = {h.method for h in c.handlers if h.surface == "worker"}
    assert {"push_task", "actor_call", "spawn_actor", "owner_refs", "owner_pin", "coll_push",
            "cancel", "stream_ack"} <= worker
    assert len([h for h in c.handlers if h.surface == "agent"]) >= 10
    assert len([h for h in c.handlers if h.surface == "driver_p2p"]) >= 5
    assert {h.file for h in c.handlers} <= {f"{PORT}/core/{m}.py" for m in
                                           ("head", "workerproc", "nodeagent", "worker",
                                            "protocol")}


def test_committed_port_contract_is_fresh():
    current = tcontract.contract_to_json(tcontract.extract_contract(tengine.collect_files(REPO)))
    with open(os.path.join(REPO, "docs", "PROTOCOL_CONTRACT_TORCH.json")) as f:
        assert json.load(f) == current, (
            "docs/PROTOCOL_CONTRACT_TORCH.json is stale: run "
            "`python -m cluster_anywhere_tpu_torch.cli lint --contract`")
    with open(os.path.join(REPO, "docs", "PROTOCOL_CONTRACT_TORCH.md")) as f:
        want = tlint.render_contract_markdown(tcontract.extract_contract(
            tengine.collect_files(REPO)))
        assert f.read() == want


def test_port_contract_is_the_jax_contract_plus_release_device():
    with open(os.path.join(REPO, "docs", "PROTOCOL_CONTRACT_TORCH.json")) as f:
        port = set(json.load(f)["methods"])
    with open(os.path.join(REPO, "docs", "PROTOCOL_CONTRACT.json")) as f:
        jax = set(json.load(f)["methods"])
    assert port - jax == {"release_device"} and jax <= port


def test_contract_writes_no_jax_file(tmp_path):
    """`ca lint --contract` on a copy of the checkout writes the port's two
    files and leaves the JAX package's contract and ARCHITECTURE.md as they
    were."""
    copy = tmp_path / "repo"
    shutil.copytree(os.path.join(REPO, PORT), copy / PORT,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    shutil.copytree(os.path.join(REPO, "scripts"), copy / "scripts")
    (copy / "docs").mkdir()
    jax_files = {"docs/PROTOCOL_CONTRACT.json": b"jax contract\n", "ARCHITECTURE.md": b"arch\n"}
    for rel, data in jax_files.items():
        (copy / rel).write_bytes(data)
    rc, out = _cli(tlint.main, ["--root", str(copy), "--contract"])
    assert rc == 0
    assert sorted(os.listdir(copy / "docs")) == ["PROTOCOL_CONTRACT.json",
                                                 "PROTOCOL_CONTRACT_TORCH.json",
                                                 "PROTOCOL_CONTRACT_TORCH.md"]
    assert {rel: (copy / rel).read_bytes() for rel in jax_files} == jax_files
    for name in ("PROTOCOL_CONTRACT_TORCH.json", "PROTOCOL_CONTRACT_TORCH.md"):
        with open(os.path.join(REPO, "docs", name), "rb") as f:
            assert (copy / "docs" / name).read_bytes() == f.read()


# -------------------------------------------------------- the chaos spec's check


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_chaos_spec_rejects_unknown_method(pkg):
    import importlib

    RpcChaos = importlib.import_module(f"{pkg}.core.protocol").RpcChaos
    with pytest.raises(ValueError, match=r"unknown RPC method.*push_taskk"):
        RpcChaos("push_taskk=1")
    with pytest.raises(ValueError, match=r"unknown RPC method.*obj_ref\b"):
        RpcChaos("", "obj_ref=5")
    RpcChaos("push_task=2,lease_grant=1,obj_refs=3", "kv_get=1")


@pytest.mark.parametrize("pkg", [JAX, PORT])
def test_chaos_spec_skips_validation_without_contract(tmp_path, monkeypatch, pkg):
    import importlib

    RpcChaos = importlib.import_module(f"{pkg}.core.protocol").RpcChaos
    monkeypatch.setenv("CA_CONTRACT_PATH", str(tmp_path / "nope.json"))
    chaos = RpcChaos("anything_goes=1")
    with pytest.raises(ConnectionError, match="anything_goes"):
        chaos.maybe_fail("anything_goes")


def test_port_chaos_reads_the_port_contract(tmp_path, monkeypatch):
    """The port validates against its own contract: a method only the port
    has passes there, and fails against the JAX package's."""
    from cluster_anywhere_tpu_torch.core.protocol import RpcChaos

    RpcChaos("release_device=1")
    monkeypatch.setenv("CA_CONTRACT_PATH", os.path.join(REPO, "docs", "PROTOCOL_CONTRACT.json"))
    with pytest.raises(ValueError, match="release_device"):
        RpcChaos("release_device=1")
