"""The port's compiled DAGs and shm channels (cluster_anywhere_tpu_torch.dag,
.channel.shm_channel) against the JAX package's.

- dag/operation.py: the operation graphs and per-actor schedules of the
  graphs of tests/test_dag.py (a chain, multi-output, input attributes,
  interleaved stages) are the JAX package's, node for node (pure
  functions: both packages run in this process, ids renumbered by
  position).
- shm_channel: frames are byte-compatible: what one package's
  BufferedShmChannel writes, the other's reader reads, a spilled frame
  (its object-store put stubbed) and the serving stream's DAG_EOF /
  DAG_ERR frames included.
- compiled DAGs: the same small programs (one actor, a two-actor chain,
  multi-output, input attributes, interleaved stages, an error and the
  channels' alignment after it, a timed-out get retried, an actor that
  dies, a task node, visualize() and actor_schedules()) give the JAX
  package's results exactly.  The JAX side runs once, in a subprocess;
  the port's on this file's cluster.

Every get and read has a timeout, the cluster's dag_execute_timeout_s is
60, and every compiled DAG is torn down in `finally`.
"""

import json
import os
import re
import subprocess
import sys
import textwrap
import types

import pytest

import cluster_anywhere_tpu.channel.shm_channel as jshm
import cluster_anywhere_tpu.core.api as japi
import cluster_anywhere_tpu.dag.node as jnode
import cluster_anywhere_tpu.dag.operation as jop
import cluster_anywhere_tpu.serve.dag_stream as jds
import cluster_anywhere_tpu_torch as ca
import cluster_anywhere_tpu_torch.channel.shm_channel as tshm
import cluster_anywhere_tpu_torch.core.api as tapi
import cluster_anywhere_tpu_torch.dag as tdag
import cluster_anywhere_tpu_torch.dag.node as tnode
import cluster_anywhere_tpu_torch.dag.operation as top
import cluster_anywhere_tpu_torch.serve.dag_stream as tds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T = 60  # seconds: the bound on every wait of this file


# ------------------------------------------------------------ schedules


def _graph(node_mod, kind):
    """(root, compute nodes) of one of tests/test_dag.py's graphs, built
    from node_mod's classes over stand-in handles named "a" and "b"."""
    cm = node_mod.ClassMethodNode
    with node_mod.InputNode() as inp:
        if kind == "chain":
            root = cm("b", "mul", (cm("a", "add", (inp,), {}),), {})
        elif kind == "multi_output":
            x = cm("a", "add", (inp,), {})
            root = node_mod.MultiOutputNode([x, cm("b", "mul", (x,), {}), cm("a", "mul", (x,), {})])
        elif kind == "input_attributes":
            root = cm("b", "pair", (cm("a", "add", (inp[0],), {}),), {"y": inp.y})
        elif kind == "interleaved":
            s0 = cm("a", "add", (inp,), {})
            s1 = cm("b", "mul", (s0,), {})
            root = cm("a", "add", (s1,), {})
        else:
            raise ValueError(kind)
    compute = [n for n in root._walk() if isinstance(n, node_mod.ClassMethodNode)]
    return root, compute


def _schedules(node_mod, op_mod, kind):
    """The operation graph and schedules of one graph, node ids replaced by
    their position in the walk (ids come from a per-package counter)."""
    root, compute = _graph(node_mod, kind)
    leaves = list(root._upstream()) if isinstance(root, node_mod.MultiOutputNode) else [root]
    channel_ids = {leaf._id for leaf in leaves}
    for n in compute:  # cross-actor edges get channels, as CompiledDAG._compile assigns them
        for dep in n._upstream():
            if isinstance(dep, node_mod.ClassMethodNode) and dep._actor != n._actor:
                channel_ids.add(dep._id)
    pos = {n._id: i for i, n in enumerate(root._walk())}
    pos[-1] = -1

    def norm(opid):
        kind_, ref = opid
        if kind_ == op_mod.READ:
            return (kind_, (pos[ref[0]], ref[1]))
        return (kind_, pos[ref])

    ops, edges = op_mod.build_operation_graph(compute, lambda n: n._actor, channel_ids, -1)
    return (
        {norm(o): dict(meta, order=pos[meta["order"]]) for o, meta in ops.items()},
        {norm(o): sorted(map(norm, s)) for o, s in edges.items()},
        {k: [norm(o) for o in v] for k, v in op_mod.generate_actor_schedules(ops, edges).items()},
        sorted((pos[i], d) for i, d in op_mod.node_depths(compute).items()),
    )


@pytest.mark.parametrize("kind", ["chain", "multi_output", "input_attributes", "interleaved"])
def test_operation_graph_and_schedules_match_jax(kind):
    assert _schedules(tnode, top, kind) == _schedules(jnode, jop, kind)


def test_interleaved_schedule_front_loads_the_shallow_stage():
    """Actor a holds stages 0 and 2: its schedule writes stage 0's output
    before it reads stage 1's, as JAX's does (test_dag.py's pipelining)."""
    _, _, sched, _ = _schedules(tnode, top, "interleaved")
    kinds = [k for k, _ in sched["a"]]
    assert kinds.index("write") < max(i for i, k in enumerate(kinds) if k == "read")


def test_a_cycle_is_a_schedule_error_in_both():
    for op_mod in (top, jop):
        ops = {("compute", 1): {"actor": "a", "depth": 0, "order": 1},
               ("compute", 2): {"actor": "a", "depth": 0, "order": 2}}
        edges = {("compute", 1): {("compute", 2)}, ("compute", 2): {("compute", 1)}}
        with pytest.raises(op_mod.ScheduleError, match="cycle"):
            op_mod.generate_actor_schedules(ops, edges)


# -------------------------------------------------------------- channels


def _segment(ch):
    """The raw bytes of a channel's slots (header and payload), the path
    and the reader acks left out."""
    out = []
    for c in ch._chans:
        mm = bytes(c._mm)
        out.append(mm[:8 * 5] + mm[c.header_size:])
    return out


@pytest.mark.parametrize("value", [
    7, "token", {"token_id": 42, "text": "a"}, [1.5, None, (2, "x")],
    b"\x00" * 3000, tds.DAG_EOF, {tds.DAG_ERR: "LLM engine pump died: boom"},
])
@pytest.mark.parametrize("writer, reader", [(jshm, tshm), (tshm, jshm)])
def test_frames_cross_between_the_packages(writer, reader, value):
    ch = writer.BufferedShmChannel(num_readers=1, num_buffers=2, buffer_size=1 << 16)
    rd = reader.open_channel(ch.spec(), 0)
    try:
        for i in range(3):  # wraps the two slots
            ch.write(value, timeout=T)
            assert rd.read(timeout=T) == value
    finally:
        rd.release()
        ch.release()


def test_frames_are_byte_identical():
    """The same writes leave the same bytes in both packages' segments."""
    segs = []
    for mod in (jshm, tshm):
        ch = mod.BufferedShmChannel(num_readers=2, num_buffers=2, buffer_size=4096)
        try:
            for v in ({"token_id": 1, "text": "x"}, tds.DAG_EOF):
                ch.write(v, timeout=T)
            segs.append(_segment(ch))
        finally:
            ch.release()
    assert segs[0] == segs[1]


@pytest.mark.parametrize("writer, reader", [(jshm, tshm), (tshm, jshm)])
def test_a_spilled_frame_crosses_between_the_packages(writer, reader, monkeypatch):
    """A payload over the segment's capacity spills: the frame carries the
    object-store ref (here a stub token) and the spill bit, and the other
    package's reader fetches through its own get."""
    store = {}
    wapi, rapi = (japi, tapi) if writer is jshm else (tapi, japi)

    def put(value):
        store["ref-1"] = value
        return "ref-1"

    monkeypatch.setattr(wapi, "put", put)
    monkeypatch.setattr(rapi, "get", lambda ref, **kw: store[ref])
    big = os.urandom(1 << 17)
    ch = writer.BufferedShmChannel(num_readers=1, num_buffers=2, buffer_size=1 << 12)
    rd = reader.open_channel(ch.spec(), 0)
    try:
        before = writer.CHANNEL_STATS["spills"]
        ch.write(big, timeout=T)
        assert writer.CHANNEL_STATS["spills"] == before + 1
        assert ch._chans[0]._get(2) >> 63 == 1  # the spill bit of the length word
        assert rd.read(timeout=T) == big
        ch.write("small", timeout=T)
        assert rd.read(timeout=T) == "small"
    finally:
        rd.release()
        ch.release()


@pytest.mark.parametrize("writer, reader", [(jshm, tds), (tshm, jds)])
def test_dag_stream_reader_reads_the_other_packages_frames(writer, reader):
    ch = writer.BufferedShmChannel(num_readers=1, num_buffers=4)
    rd = reader.open_dag_stream(ch.spec(), timeout_s=T)
    try:
        for i in range(3):
            ch.write({"token_id": i, "text": str(i)}, timeout=T)
        ch.write(tds.DAG_EOF, timeout=T)
        assert [f["token_id"] for f in rd] == [0, 1, 2]
        assert ch.wait_consumed(T)
    finally:
        ch.release()
    ch = writer.BufferedShmChannel(num_readers=1, num_buffers=4)
    rd = reader.open_dag_stream(ch.spec(), timeout_s=T)
    try:
        ch.write({"token_id": 5, "text": "5"}, timeout=T)
        ch.write({tds.DAG_ERR: "LLM engine pump died: boom"}, timeout=T)
        it = iter(rd)
        assert next(it)["token_id"] == 5
        with pytest.raises(RuntimeError, match="pump died: boom"):
            next(it)
    finally:
        ch.release()


def test_a_read_times_out_and_a_closed_channel_raises():
    ch = tshm.BufferedShmChannel(num_readers=1, num_buffers=2)
    rd = tshm.open_channel(ch.spec(), 0)
    try:
        with pytest.raises(TimeoutError):
            rd.read(timeout=0.05)
        ch.close()
        with pytest.raises(tshm.ChannelClosedError):
            rd.read(timeout=T)
    finally:
        rd.release()
        ch.release()


# ---------------------------------------------------------- compiled DAGs

# Each case runs on an initialised cluster of `ca` (either package) and
# returns plain values.  The actor classes are defined inside the cases, so
# they travel to the workers by value.
PROGRAM = textwrap.dedent('''
    import os
    import re
    import time


    def _stage(ca):
        @ca.remote
        class Stage:
            def __init__(self, k):
                self.k = k

            def add(self, x):
                return x + self.k

            def mul(self, x):
                return x * self.k

            def pair(self, x, y=None):
                return [x, y]

            def check(self, x):
                if x < 0:
                    raise ValueError(f"negative {x}")
                return x * 10

            def slow(self, x):
                time.sleep(x)
                return x

            def die(self, x):
                if x == "die":
                    os._exit(1)
                return x

        return Stage


    def _run(node, fn):
        d = node.experimental_compile()
        try:
            return fn(d)
        finally:
            d.teardown()


    def case_single(ca, dag):
        a = _stage(ca).remote(1)
        with dag.InputNode() as inp:
            n = a.add.bind(inp)
        return _run(n, lambda d: [d.execute(i).get(timeout=60) for i in range(3)])


    def case_chain(ca, dag):
        Stage = _stage(ca)
        a, b = Stage.remote(1), Stage.remote(10)
        with dag.InputNode() as inp:
            n = b.mul.bind(a.add.bind(inp))
        return _run(n, lambda d: [d.execute(i).get(timeout=60) for i in range(4)])


    def case_multi_output(ca, dag):
        Stage = _stage(ca)
        a, b = Stage.remote(1), Stage.remote(10)
        with dag.InputNode() as inp:
            x = a.add.bind(inp)
            n = dag.MultiOutputNode([x, b.mul.bind(x), a.mul.bind(x)])
        return _run(n, lambda d: [d.execute(i).get(timeout=60) for i in range(3)])


    def case_input_attributes(ca, dag):
        Stage = _stage(ca)
        a, b = Stage.remote(1), Stage.remote(10)
        with dag.InputNode() as inp:
            n = b.pair.bind(a.add.bind(inp[0]), y=inp.y)
        return _run(n, lambda d: [d.execute(i, y=f"y{i}").get(timeout=60) for i in range(3)])


    def case_interleaved(ca, dag):
        Stage = _stage(ca)
        a, b = Stage.remote(1), Stage.remote(10)
        with dag.InputNode() as inp:
            n = a.add.bind(b.mul.bind(a.add.bind(inp)))

        def pipelined(d):
            refs = [d.execute(i) for i in range(2)]  # max_inflight_executions=2
            return [r.get(timeout=60) for r in refs] + [d.execute(5).get(timeout=60)]

        return _run(n, pipelined)


    def case_error_then_aligned(ca, dag):
        Stage = _stage(ca)
        a, b = Stage.remote(1), Stage.remote(10)
        with dag.InputNode() as inp:
            n = b.add.bind(a.check.bind(inp))

        def run(d):
            out = [d.execute(1).get(timeout=60)]
            try:
                d.execute(-1).get(timeout=60)
                out.append("no error")
            except Exception as e:
                out.append([type(e).__name__, str(e)])
            out += [d.execute(i).get(timeout=60) for i in (2, 3)]
            return out

        return _run(n, run)


    def case_timeout_retry(ca, dag):
        a = _stage(ca).remote(1)
        with dag.InputNode() as inp:
            n = a.slow.bind(inp)

        def run(d):
            ref = d.execute(1.5)
            try:
                ref.get(timeout=0.2)
                first = "no timeout"
            except dag.DagTimeoutError as e:
                first = [type(e).__name__, isinstance(e, TimeoutError)]
            return [first, ref.get(timeout=60), d.execute(0.0).get(timeout=60)]

        return _run(n, run)


    def case_actor_death(ca, dag):
        c = _stage(ca).remote(0)
        with dag.InputNode() as inp:
            n = c.die.bind(inp)

        def run(d):
            out = [d.execute("ok").get(timeout=60)]
            t0 = time.monotonic()
            try:
                d.execute("die").get(timeout=60)
                out.append("no error")
            except dag.DeadActorError as e:
                out.append([type(e).__name__, isinstance(e, ca.ActorDiedError),
                            time.monotonic() - t0 < 30])
            try:
                d.execute("ok")
                out.append("usable")
            except dag.DeadActorError:
                out.append("DeadActorError again")
            return out

        return _run(n, run)


    def case_task_node(ca, dag):
        @ca.remote
        def add(x, y):
            return x + y

        with dag.InputNode() as inp:
            n = add.bind(add.bind(inp, 1), 10)
        out = [ca.get(n.execute(5), timeout=60), type(n).__name__]
        try:
            n.experimental_compile()
            out.append("compiled")
        except TypeError as e:
            out.append([type(e).__name__, str(e)])
        return out


    def case_visualize_and_schedules(ca, dag):
        Stage = _stage(ca)
        a, b = Stage.remote(1), Stage.remote(10)
        with dag.InputNode() as inp:
            n = a.add.bind(b.mul.bind(a.add.bind(inp)))
        names = {a.actor_id.hex(): "a", b.actor_id.hex(): "b"}
        pos = {m._id: i for i, m in enumerate(n._walk())}
        pos[-1] = -1

        def run(d):
            text = d.visualize()
            for hexid, name in names.items():
                text = text.replace(hexid, name)
            text = re.sub(r"\\d+", lambda m: str(pos.get(int(m.group()), m.group())), text)
            scheds = {names[k]: [[kind, pos[ref]] for kind, ref in v]
                      for k, v in d.actor_schedules().items()}
            return [text, scheds]

        return _run(n, run)


    CASES = [name for name in list(globals()) if name.startswith("case_")]
''')

CASES = [n for n in re.findall(r"^def (case_\w+)", PROGRAM, re.M)]

JAX_MAIN = PROGRAM + textwrap.dedent('''
    import json
    import sys

    import cluster_anywhere_tpu as ca
    import cluster_anywhere_tpu.dag as dag

    ca.init(num_cpus=4, dag_execute_timeout_s=60)
    try:
        out = {name: globals()[name](ca, dag) for name in CASES}
    finally:
        ca.shutdown()
    print("RESULT " + json.dumps(out))
''')


def _port_cases():
    mod = types.ModuleType("torch_dag_program")  # no worker can import it: by value
    exec(compile(PROGRAM, "torch_dag_program", "exec"), mod.__dict__)
    return mod


@pytest.fixture(scope="module")
def cluster():
    if ca.is_initialized():
        ca.shutdown()
    ca.init(num_cpus=4, num_gpus=0, dag_execute_timeout_s=60)
    yield
    ca.shutdown()


@pytest.fixture(scope="module", autouse=True)
def jax_results():
    """The JAX package's results of the cases, from a subprocess started
    with the file so that it overlaps the port's tests; the fixture is a
    function that waits for them."""
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", JAX_MAIN], env=env, cwd="/",
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    box = {}

    def results():
        if "out" not in box:
            out, err = proc.communicate(timeout=3 * T)
            assert proc.returncode == 0, err[-3000:]
            line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
            box["out"] = json.loads(line[len("RESULT "):])
        return box["out"]

    yield results
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def test_bind_makes_dag_nodes(cluster):
    """Actor-method and task .bind give the port's node classes (they
    raised before dag/ was ported), and the DAG's deadline is the
    session's dag_execute_timeout_s."""
    stage = _port_cases()._stage(ca).remote(1)
    node = stage.add.bind(2)
    assert type(node) is tnode.ClassMethodNode and node._actor is stage
    assert type(_port_cases()._stage(ca).remote(3).mul.bind(node)) is tnode.ClassMethodNode

    @ca.remote
    def f(x):
        return x

    assert type(f.bind(1)) is tnode.FunctionNode
    compiled = node.experimental_compile()
    try:
        assert compiled._timeout == 60
        assert compiled.execute().get(timeout=T) == 3
    finally:
        compiled.teardown()


@pytest.fixture(scope="module")
def port_results(cluster):
    """Every case on the port's cluster, run before the first comparison
    waits for the JAX side; a case that raised holds its error."""
    cases, out = _port_cases(), {}
    for case in CASES:
        try:
            out[case] = json.loads(json.dumps(getattr(cases, case)(ca, tdag)))
        except Exception as e:  # reported by the case's test
            out[case] = e
    return out


@pytest.mark.parametrize("case", CASES)
def test_compiled_dag_matches_jax(case, port_results, jax_results):
    got = port_results[case]
    if isinstance(got, Exception):
        raise got
    assert got == jax_results()[case]


def test_the_cases_check_what_they_claim(jax_results):
    """The reference's answers are the ones the cases are written for, so a
    fault common to both packages cannot pass as parity."""
    jax_results = jax_results()
    assert jax_results["case_chain"] == [10, 20, 30, 40]
    assert jax_results["case_error_then_aligned"] == [
        20, ["ValueError", "negative -1"], 30, 40]
    assert jax_results["case_timeout_retry"] == [["DagTimeoutError", True], 1.5, 0.0]
    assert jax_results["case_actor_death"][1] == ["DeadActorError", True, True]
    assert jax_results["case_task_node"][:2] == [16, "FunctionNode"]
