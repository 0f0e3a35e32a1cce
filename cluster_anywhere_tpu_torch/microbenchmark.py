"""`ca microbenchmark` — the reference's `ray microbenchmark`
(python/ray/_private/ray_perf.py:93) surface: one command printing the
canonical single-node micro numbers, plus one A/B per plane.

Everything runs in host processes except the LLM replicas of `--serve` and
`--dag` (run_serve_plane, run_dag_plane), which run on the card: they take
`device=None` (the card; they raise before starting a session when there is
none) or `device="cpu"`.  Functions and actors shipped to workers import
this package by name, never the JAX one.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

# the GPU share of each LLM replica of run_serve_plane: its replica, the
# admission-off redeploy (which overlaps it while the old one drains) and
# the prefix-cache replica must all be placed on one card
REPLICA_GPUS = 0.25


def _rate(n: int, fn: Callable[[], None]) -> float:
    t0 = time.perf_counter()
    fn()
    return n / (time.perf_counter() - t0)


def run_microbenchmarks(quick: bool = False) -> List[Tuple[str, float, str]]:
    """Returns [(metric, value, unit)] and prints them as it goes."""
    from .core import api as ca

    owns = not ca.is_initialized()
    if owns:
        ca.init(num_cpus=4)
    results: List[Tuple[str, float, str]] = []

    def record(name: str, value: float, unit: str):
        results.append((name, value, unit))
        print(f"{name}: {value:,.1f} {unit}")

    scale = 0.2 if quick else 1.0

    @ca.remote
    def noop():
        return None

    # warm the pool AND wait out prestarted-worker registration: interpreter
    # startups compete with the head for the core and poison early numbers
    ca.get([noop.remote() for _ in range(50)])
    from .core.worker import global_worker

    w = global_worker()
    deadline = time.monotonic() + 10
    want = int(ca.cluster_resources().get("CPU", 1))
    while time.monotonic() < deadline:
        alive = [
            x for x in w.head_call("list_workers")["workers"]
            if x.get("state") in ("idle", "leased")
        ]
        if len(alive) >= want:
            break
        time.sleep(0.2)
    time.sleep(0.5)

    n = int(5000 * scale)
    record(
        "single client tasks async",
        _rate(n, lambda: ca.get([noop.remote() for _ in range(n)])),
        "/s",
    )

    n = int(500 * scale)

    def sync_tasks():
        for _ in range(n):
            ca.get(noop.remote())

    record("single client tasks sync", _rate(n, sync_tasks), "/s")

    @ca.remote
    class A:
        def ping(self):
            return None

    a = A.remote()
    ca.get(a.ping.remote())
    n = int(5000 * scale)
    record(
        "1:1 actor calls async",
        _rate(n, lambda: ca.get([a.ping.remote() for _ in range(n)])),
        "/s",
    )
    n = int(500 * scale)

    def sync_actor():
        for _ in range(n):
            ca.get(a.ping.remote())

    record("1:1 actor calls sync", _rate(n, sync_actor), "/s")
    from .core.actor import kill as _kill

    _kill(a)

    # puts: value churn through the object store
    n = int(1000 * scale)
    small = np.arange(16)
    record(
        "single client put calls",
        _rate(n, lambda: [ca.put(small) for _ in range(n)]),
        "/s",
    )
    n = int(2000 * scale)
    refs = [ca.put(small) for _ in range(n)]
    record(
        "single client get calls",
        _rate(n, lambda: [ca.get(r) for r in refs]),
        "/s",
    )
    del refs

    size = 64 * 1024 * 1024 if quick else 256 * 1024 * 1024
    arr = np.frombuffer(np.random.bytes(size), dtype=np.uint8)
    reps = 2 if quick else 4
    warm = [ca.put(arr) for _ in range(reps)]
    del warm
    time.sleep(0.5)
    t0 = time.perf_counter()
    big = [ca.put(arr) for _ in range(reps)]
    record(
        "single client put gigabytes",
        reps * size / (time.perf_counter() - t0) / 1e9,
        "GB/s",
    )
    del big

    # placement group create/remove churn.  Earlier phases' task leases
    # idle-return after ~1s; wait for full capacity or the first PG goes
    # PENDING and the average collapses to the service-tick cadence.
    from .core.placement import placement_group, remove_placement_group

    total_cpu = ca.cluster_resources().get("CPU", 0)
    deadline = time.monotonic() + 10
    while (
        ca.available_resources().get("CPU", 0) < total_cpu
        and time.monotonic() < deadline
    ):
        time.sleep(0.1)

    n = int(100 * scale)

    def pg_churn():
        for _ in range(n):
            pg = placement_group([{"CPU": 1}])
            pg.wait(10)
            remove_placement_group(pg)

    record("placement group create/removal", _rate(n, pg_churn), "/s")

    # wait over a 1k-ref frontier (ray_perf "single client wait 1k refs")
    refs1k = [ca.put(small) for _ in range(1000)]
    n = max(3, int(10 * scale))

    def wait_1k():
        for _ in range(n):
            ready, _ = ca.wait(refs1k, num_returns=1000, timeout=60)
            assert len(ready) == 1000

    record("single client wait 1k refs", _rate(n, wait_1k), "/s")
    del refs1k

    # container deserialization fan-out (ray_perf "get containing 10k refs")
    refs10k = [ca.put(i) for i in range(10000)]
    container = ca.put(refs10k)
    n = max(3, int(10 * scale))
    record(
        "get object containing 10k refs",
        _rate(n, lambda: [ca.get(container) for _ in range(n)]),
        "/s",
    )
    del container, refs10k

    if owns:
        ca.shutdown()
    return results


def run_multiclient(quick: bool = False) -> List[Tuple[str, float, str]]:
    """The multi-client aggregate rows (ray_perf.py multi-client variants):
    K client ACTORS drive submissions concurrently — same shape as the
    reference, which uses worker processes as clients.  The clients, their
    targets, the head and the pool workers share the host's cores, so on a
    host with few cores these aggregate numbers are a lower bound."""
    from .core import api as ca

    owns = not ca.is_initialized()
    if owns:
        ca.init(num_cpus=4)
    results: List[Tuple[str, float, str]] = []

    def record(name: str, value: float, unit: str):
        results.append((name, value, unit))
        print(f"{name}: {value:,.1f} {unit}")

    scale = 0.2 if quick else 1.0
    k = 4

    @ca.remote(num_cpus=0)
    class Client:
        """A driver-role actor (num_cpus=0: clients must not occupy the CPU
        slots their own submitted tasks need — the reference's multi-client
        rows likewise run the drivers outside the worker pool)."""

        def __init__(self):
            import cluster_anywhere_tpu_torch as ca2

            @ca2.remote
            def noop():
                return None

            self._noop = noop

        def tasks_async(self, n):
            import cluster_anywhere_tpu_torch as ca2

            noop = self._noop
            t0 = time.perf_counter()
            ca2.get([noop.remote() for _ in range(n)])
            return n / (time.perf_counter() - t0)

        def drive_actor(self, target, n):
            import cluster_anywhere_tpu_torch as ca2

            t0 = time.perf_counter()
            ca2.get([target.ping.remote() for _ in range(n)])
            return n / (time.perf_counter() - t0)

        def puts(self, n, nbytes):
            import numpy as _np

            import cluster_anywhere_tpu_torch as ca2

            arr = _np.frombuffer(_np.random.bytes(nbytes), dtype=_np.uint8)
            t0 = time.perf_counter()
            refs = [ca2.put(arr) for _ in range(n)]
            dt = time.perf_counter() - t0
            del refs
            return n * nbytes / dt

    @ca.remote(num_cpus=0)
    class Target:
        def ping(self):
            return None

    clients = [Client.remote() for _ in range(k)]
    n = int(2000 * scale)
    # warmup: client-side pools spin up
    ca.get([c.tasks_async.remote(50) for c in clients])
    t0 = time.perf_counter()
    ca.get([c.tasks_async.remote(n) for c in clients], timeout=600)
    record(
        "multi client tasks async",
        k * n / (time.perf_counter() - t0),
        "/s",
    )

    targets = [Target.remote() for _ in range(k)]
    ca.get([t.ping.remote() for t in targets])
    n = int(2000 * scale)
    t0 = time.perf_counter()
    ca.get(
        [c.drive_actor.remote(t, n) for c, t in zip(clients, targets)],
        timeout=600,
    )
    record("n:n actor calls async", k * n / (time.perf_counter() - t0), "/s")

    nbytes = 16 * 1024 * 1024 if quick else 64 * 1024 * 1024
    reps = 2 if quick else 4
    ca.get([c.puts.remote(1, nbytes) for c in clients])  # warm arenas
    t0 = time.perf_counter()
    ca.get([c.puts.remote(reps, nbytes) for c in clients], timeout=600)
    record(
        "multi client put gigabytes",
        k * reps * nbytes / (time.perf_counter() - t0) / 1e9,
        "GB/s",
    )

    from .core.actor import kill as _kill

    for h in clients + targets:
        _kill(h)
    if owns:
        ca.shutdown()
    return results


def run_scalability(quick: bool = False) -> List[Tuple[str, float, str]]:
    """Scalability-envelope probes (release/perf_metrics/scalability/
    single_node.json rows, honestly scaled to this host and labeled with
    their sizes): many-args, many-returns, many-gets, and a bounded
    queued-task flood."""
    from .core import api as ca

    owns = not ca.is_initialized()
    if owns:
        ca.init(num_cpus=4)
    results: List[Tuple[str, float, str]] = []

    def record(name: str, value: float, unit: str):
        results.append((name, value, unit))
        print(f"{name}: {value:,.2f} {unit}")

    n_args = 2000 if quick else 10000
    refs = [ca.put(i) for i in range(n_args)]

    @ca.remote
    def consume_many(*args):
        return len(args)

    t0 = time.perf_counter()
    got = ca.get(consume_many.remote(*refs), timeout=600)
    assert got == n_args
    record(f"{n_args} object args to one task", time.perf_counter() - t0, "s")
    del refs

    n_ret = 600 if quick else 3000

    @ca.remote
    def many_returns():
        return tuple(range(n_ret))

    t0 = time.perf_counter()
    out = ca.get(
        many_returns.options(num_returns=n_ret).remote(), timeout=600
    )
    assert len(out) == n_ret
    record(f"{n_ret} returns from one task", time.perf_counter() - t0, "s")

    n_get = 2000 if quick else 10000

    @ca.remote
    def make_refs(k):
        import cluster_anywhere_tpu_torch as ca2

        return [ca2.put(i) for i in range(k)]

    # the refs are owned by a WORKER: the driver's get exercises the real
    # resolution path (borrowed-ref seeding against the owner's directory),
    # not its own local value cache
    refs = ca.get(make_refs.remote(n_get), timeout=300)
    t0 = time.perf_counter()
    vals = ca.get(refs, timeout=600)
    assert len(vals) == n_get and vals[1] == 1
    record(f"get of {n_get} worker-owned objects", time.perf_counter() - t0, "s")
    del refs, vals

    # queued-task flood: 100k here (the reference's 1M row ran on an
    # m4.16xlarge; the claim under test — the submission/lease pipeline keeps
    # absorbing tasks far beyond pool capacity without collapse — scales down)
    n_flood = 20000 if quick else 100000

    @ca.remote
    def tiny():
        return None

    t0 = time.perf_counter()
    flood = [tiny.remote() for _ in range(n_flood)]
    submit_dt = time.perf_counter() - t0
    ca.get(flood, timeout=1200)
    total_dt = time.perf_counter() - t0
    record(f"{n_flood} queued tasks submit", submit_dt, "s")
    record(f"{n_flood} queued tasks drain", total_dt, "s")

    if owns:
        ca.shutdown()
    return results


def run_collective_bw(quick: bool = False) -> List[Tuple[str, float, str]]:
    """Host (out-of-graph) allreduce bandwidth over the p2p backend, with
    proof that no per-op traffic landed on the head."""
    from .core import api as ca

    owns = not ca.is_initialized()
    if owns:
        ca.init(num_cpus=4)
    results: List[Tuple[str, float, str]] = []

    def record(name: str, value: float, unit: str):
        results.append((name, value, unit))
        print(f"{name}: {value:,.2f} {unit}")

    from .parallel import collectives as coll

    @ca.remote
    class Rank(coll.CollectiveActorMixin):
        def warm(self, nbytes, group):
            import numpy as _np

            # peer resolution + connection setup + first-op buffers
            coll.allreduce(_np.zeros(nbytes // 4, _np.float32), group_name=group)
            return True

        def bench(self, nbytes, reps, group):
            import numpy as _np

            arr = _np.frombuffer(_np.random.bytes(nbytes), dtype=_np.float32)
            t0 = time.perf_counter()
            for _ in range(reps):
                out = coll.allreduce(arr, group_name=group)
            dt = time.perf_counter() - t0
            assert out.shape == arr.shape
            return reps * nbytes / dt

    from .core.actor import kill as _kill
    from .core.worker import global_worker

    nbytes = 8 * 1024 * 1024 if quick else 64 * 1024 * 1024
    reps = 3 if quick else 5
    for world in (2, 4):
        ranks = [Rank.remote() for _ in range(world)]
        coll.create_collective_group(
            ranks, world, list(range(world)), group_name=f"bw{world}"
        )
        ca.get([r.warm.remote(nbytes, f"bw{world}") for r in ranks], timeout=120)
        before = global_worker().head_call("stats").get("rpc_counts", {})
        per_rank = ca.get(
            [r.bench.remote(nbytes, reps, f"bw{world}") for r in ranks], timeout=600
        )
        after = global_worker().head_call("stats").get("rpc_counts", {})
        # input-size bandwidth per rank (the ring moves 2(N-1)/N x input
        # bytes on the wire; this is the user-visible "allreduce of X bytes
        # took T")
        record(
            f"host allreduce ({world} ranks, {nbytes >> 20} MB)",
            min(per_rank) / 1e9,
            "GB/s per rank",
        )
        head_delta = sum(
            after.get(m, 0) - before.get(m, 0)
            for m in ("kv_get", "kv_put", "kv_keys", "obj_locate")
        )
        record(
            f"head KV/locate ops during allreduce loop ({world} ranks)",
            head_delta,
            "ops",
        )
        coll.destroy_group_on(ranks, f"bw{world}")
        for r in ranks:
            _kill(r)
    if owns:
        ca.shutdown()
    return results


def run_lease_plane(quick: bool = False) -> List[Tuple[str, float, str]]:
    """`ca microbenchmark --lease-plane`: A/B the lease plane.  A task flood
    against a multi-node cluster with node-local granting ON (agents grant
    out of head-delegated lease blocks) vs OFF (every lease crosses the
    head's loop), with the head's request_lease RPC delta printed as the
    structural proof — local granting should leave it ~0 in steady state."""
    from .cluster_utils import Cluster
    from .core import api as ca
    from .core.config import CAConfig
    from .core.worker import LEASE_STATS, global_worker

    results: List[Tuple[str, float, str]] = []

    def record(name: str, value: float, unit: str):
        results.append((name, value, unit))
        print(f"{name}: {value:,.1f} {unit}")

    n = 1000 if quick else 4000

    def flood(delegation: bool):
        cfg = CAConfig()
        cfg.lease_delegation = delegation
        cluster = Cluster(head_resources={"CPU": 0}, config=cfg)
        cluster.add_node(num_cpus=2)
        cluster.add_node(num_cpus=2)
        cluster.connect()
        try:
            @ca.remote
            def noop():
                return None

            w = global_worker()
            ca.get([noop.remote() for _ in range(100)], timeout=120)
            # let the warm leases idle-return so the measured flood actually
            # exercises the grant path (and, with delegation on, gives the
            # head a beat to hand the freed idle workers to the agents)
            deadline = time.monotonic() + 15
            while time.monotonic() < deadline:
                stats = w.head_call("stats")["stats"]
                if not delegation or stats.get("lease_delegated_slots", 0) >= 2:
                    if stats.get("idle_workers", 0) or stats.get(
                        "lease_delegated_slots", 0
                    ):
                        break
                time.sleep(0.2)
            local0 = LEASE_STATS["local_grants"]
            before = w.head_call("stats")["rpc_counts"].get("request_lease", 0)
            t0 = time.perf_counter()
            ca.get([noop.remote() for _ in range(n)], timeout=300)
            dt = time.perf_counter() - t0
            after = w.head_call("stats")["rpc_counts"].get("request_lease", 0)
            rate = n / dt
            # bursty phase: bursts separated by > the lease idle timeout, so
            # EVERY burst re-acquires leases — the lease-churn traffic class
            # the delegation moves off the head (a steady warm flood hides
            # it behind lease reuse).  Per-burst head lease ops is the
            # structural number: ~0 local vs several per burst central.
            bursts = 4 if quick else 8
            lease_ops = ("request_lease", "return_lease")
            rc0 = w.head_call("stats")["rpc_counts"]
            b0 = sum(rc0.get(m, 0) for m in lease_ops)
            for _ in range(bursts):
                time.sleep(1.3)  # leases idle-return between bursts
                ca.get([noop.remote() for _ in range(100)], timeout=120)
            rc1 = w.head_call("stats")["rpc_counts"]
            per_burst = (sum(rc1.get(m, 0) for m in lease_ops) - b0) / bursts
            return rate, after - before, LEASE_STATS["local_grants"] - local0, per_burst
        finally:
            cluster.shutdown()

    rate, head_rpcs, local, per_burst = flood(True)
    record("lease plane local-grant tasks", rate, "/s")
    print(f"  head request_lease RPCs during flood: {head_rpcs} "
          f"(local grants: {local})")
    record("lease plane head lease-ops/burst (local)", per_burst, "ops")
    rate_off, head_rpcs_off, _, per_burst_off = flood(False)
    record("lease plane head-grant tasks", rate_off, "/s")
    print(f"  head request_lease RPCs during flood: {head_rpcs_off}")
    record("lease plane head lease-ops/burst (central)", per_burst_off, "ops")
    return results


def run_owner_plane(quick: bool = False) -> List[Tuple[str, float, str]]:
    """`ca microbenchmark --owner-plane`: A/B the ownership plane.  A
    steady-state object workload — driver creates shm objects, workers
    borrow them (inline holder lists smuggle the refs: transit pins +
    borrower registration + release, the lease-plane test pattern extended
    to objects) — with owner-resident settlement ON vs OFF.  The structural
    proof is the head's per-object obj_refs message count: ~0 with the
    plane on (inc/dec/pins/acks settle at owner ledgers over direct
    connections) vs >= 1 centralized.  A final phase kills the head
    mid-workload and shows cluster-wide GC still completing (owner ledgers
    are the lifetime authority; the head is only the registry)."""
    import numpy as np

    from .cluster_utils import Cluster
    from .core import api as ca
    from .core.config import CAConfig
    from .core.worker import global_worker

    results: List[Tuple[str, float, str]] = []

    def record(name: str, value: float, unit: str):
        results.append((name, value, unit))
        print(f"{name}: {value:,.2f} {unit}")

    n = 150 if quick else 600
    arr = np.arange(4000)  # ~32KB: shm-backed, registered at the head
    want = int(arr.sum())

    def arena_bytes(w) -> int:
        return sum(
            a.size - sum(sz for _, sz in a.free)
            for a in w.shm_store._arenas.values()
        )

    def workload(owner_plane: bool):
        cfg = CAConfig()
        cfg.owner_plane = owner_plane
        cluster = Cluster(head_resources={"CPU": 4}, config=cfg)
        cluster.connect()
        try:
            @ca.remote
            def borrow(holder):
                return int(ca.get(holder[0]).sum())

            # warm the pool + connections
            ca.get(
                [borrow.remote([ca.put(arr)]) for _ in range(20)], timeout=120
            )
            w = global_worker()
            time.sleep(1.0)  # let warmup refcounts settle before counting
            ops = ("obj_refs", "transit_done")
            rc0 = w.head_call("stats")["rpc_counts"]
            t0 = time.perf_counter()
            refs = [ca.put(arr) for _ in range(n)]
            outs = ca.get([borrow.remote([r]) for r in refs], timeout=600)
            assert all(o == want for o in outs)
            del refs, outs
            # settlement proof: every arena slice reclaimed, not just fast
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline and arena_bytes(w) > 0:
                time.sleep(0.2)
            leaked = arena_bytes(w)
            dt = time.perf_counter() - t0
            rc1 = w.head_call("stats")["rpc_counts"]
            per_obj = {
                m: (rc1.get(m, 0) - rc0.get(m, 0)) / n for m in ops
            }
            return n / dt, per_obj, leaked
        finally:
            cluster.shutdown()

    rate_on, per_on, leaked_on = workload(True)
    record("owner plane objects (ledger)", rate_on, "obj/s")
    record("owner plane head obj_refs/object (ledger)", per_on["obj_refs"], "ops")
    record(
        "owner plane head transit_done/object (ledger)",
        per_on["transit_done"], "ops",
    )
    print(f"  leaked arena bytes after settle: {leaked_on}")
    rate_off, per_off, leaked_off = workload(False)
    record("owner plane objects (centralized)", rate_off, "obj/s")
    record(
        "owner plane head obj_refs/object (centralized)",
        per_off["obj_refs"], "ops",
    )
    record(
        "owner plane head transit_done/object (centralized)",
        per_off["transit_done"], "ops",
    )
    print(f"  leaked arena bytes after settle: {leaked_off}")

    # --- GC with the head down mid-workload (ownership plane only) --------
    cluster = Cluster(head_resources={"CPU": 2})
    cluster.connect()
    try:
        w = global_worker()
        big = np.zeros(200_000)  # 1.6MB: shm-backed from the first put
        refs = [ca.put(big) for _ in range(20)]
        assert arena_bytes(w) > 0
        cluster.kill_head()
        time.sleep(0.5)
        del refs
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and arena_bytes(w) > 0:
            time.sleep(0.2)
        leaked = arena_bytes(w)
        record("owner plane GC with head down (leaked bytes)", leaked, "B")
        cluster.restart_head()
    finally:
        cluster.shutdown()
    return results


def run_metrics_plane(quick: bool = False) -> List[Tuple[str, float, str]]:
    """`ca microbenchmark --metrics-plane`: A/B the metrics plane.  With the
    plane ON, agent-node workers ship metric deltas to their node agent
    (piggybacked head-ward on node_sync) and Prometheus scrapes the agents'
    HTTP endpoints — a scrape costs the head ZERO RPCs.  With it OFF, every
    worker reports straight to the head each flush and a scrape is a
    `metrics_snapshot` head RPC.  The structural rows are head metrics-RPC
    traffic per scrape in each mode; the final phase kills the head and
    shows the node endpoint still serving exposition text (scrape survives
    a dead head)."""
    import urllib.request

    from .cluster_utils import Cluster
    from .core import api as ca
    from .core.config import CAConfig
    from .core.worker import global_worker

    results: List[Tuple[str, float, str]] = []

    def record(name: str, value: float, unit: str):
        results.append((name, value, unit))
        print(f"{name}: {value:,.2f} {unit}")

    n_scrapes = 5 if quick else 20
    scrape_gap = 0.25  # leaves room for flush ticks between scrapes

    def node_scrape(cluster, nid: str) -> str:
        addr = open(
            os.path.join(cluster.session_dir, "nodes", nid, "metrics.addr")
        ).read().strip()
        with urllib.request.urlopen(addr + "/metrics", timeout=10) as r:
            return r.read().decode()

    def workload(plane_on: bool):
        cfg = CAConfig()
        cfg.metrics_plane = plane_on
        cluster = Cluster(head_resources={"CPU": 1}, config=cfg)
        nid = cluster.add_node(num_cpus=2)
        cluster.connect()
        try:
            @ca.remote
            def noisy(i):
                from cluster_anywhere_tpu_torch.util.metrics import Counter

                Counter("mb_metricsplane_total", "a/b traffic source").inc()
                return i

            ca.get([noisy.remote(i) for i in range(40)], timeout=120)
            time.sleep(2.0)  # a couple of flush ticks settle the pipeline
            w = global_worker()
            rc0 = w.head_call("stats")["rpc_counts"]
            for _ in range(n_scrapes):
                if plane_on:
                    text = node_scrape(cluster, nid)
                    assert "ca_node_agent" in text
                else:
                    w.head_call("metrics_snapshot")
                time.sleep(scrape_gap)
            rc1 = w.head_call("stats")["rpc_counts"]
            per_scrape = {
                m: (rc1.get(m, 0) - rc0.get(m, 0)) / n_scrapes
                for m in ("metrics_snapshot", "metrics_report")
            }
            return per_scrape, cluster, nid
        except BaseException:
            cluster.shutdown()
            raise

    per_on, cluster_on, nid_on = workload(True)
    record(
        "metrics plane head snapshot RPCs/scrape (node scrape)",
        per_on["metrics_snapshot"], "ops",
    )
    record(
        "metrics plane head report RPCs/scrape (node scrape)",
        per_on["metrics_report"], "ops",
    )
    # --- scrape with the head DOWN (the plane's reason to exist) ----------
    try:
        cluster_on.kill_head()
        time.sleep(0.5)
        text = node_scrape(cluster_on, nid_on)
        ok = 1.0 if ("ca_node_agent_scrapes_total" in text and "# TYPE" in text) else 0.0
        record("metrics plane scrape with head down (1=ok)", ok, "")
        cluster_on.restart_head()
    finally:
        cluster_on.shutdown()

    per_off, cluster_off, _ = workload(False)
    try:
        record(
            "metrics plane head snapshot RPCs/scrape (head RPC)",
            per_off["metrics_snapshot"], "ops",
        )
        record(
            "metrics plane head report RPCs/scrape (head RPC)",
            per_off["metrics_report"], "ops",
        )
    finally:
        cluster_off.shutdown()
    return results


def run_transfer_plane(quick: bool = False) -> List[Tuple[str, float, str]]:
    """`ca microbenchmark --transfer`: A/B the bulk-transfer data plane.

    (1) Serial vs windowed object pulls on a LATENCY-INJECTED link
    (config.testing_transfer_delay_s per served chunk, so the number
    measures pipelining, not this host's memcpy speed), with the structural
    columns — window occupancy (avg per-pull peak in-flight pull_chunk
    RPCs) and head RPCs per pulled object (must not grow with the window).
    (2) 1-source vs 2-source pulls of an object with two live copies.
    (3) f32 vs int8/bf16 quantized host collective ring at 64 MB
    (effective bytes/s = input bytes reduced per second)."""
    from .cluster_utils import Cluster
    from .core import api as ca
    from .core.config import CAConfig
    from .core.scheduling_strategies import NodeAffinitySchedulingStrategy
    from .core.worker import TRANSFER_STATS, global_worker

    results: List[Tuple[str, float, str]] = []

    def record(name: str, value: float, unit: str):
        results.append((name, value, unit))
        print(f"{name}: {value:,.2f} {unit}")

    delay = 0.02
    chunk = 256 * 1024
    nobj = 2 if quick else 4
    size = 4 * 1024**2 if quick else 8 * 1024**2

    def pull_bench(window: int, two_sources: bool = False, multi: bool = True):
        cfg = CAConfig()
        cfg.transfer_window = window
        cfg.transfer_chunk_bytes = chunk
        cfg.testing_transfer_delay_s = delay
        cfg.transfer_multi_source = multi
        cluster = Cluster(head_resources={"CPU": 1}, config=cfg)
        n1 = cluster.add_node(num_cpus=2)
        n2 = cluster.add_node(num_cpus=2) if two_sources else None
        cluster.connect()
        cluster.wait_for_nodes(3 if two_sources else 2)
        try:
            @ca.remote
            def produce(n):
                import numpy as _np

                return _np.frombuffer(_np.random.bytes(n), dtype=_np.uint8)

            @ca.remote
            def touch(a):
                return int(a[0]) + int(a[-1])

            na = NodeAffinitySchedulingStrategy
            refs = [
                produce.options(scheduling_strategy=na(n1)).remote(size)
                for _ in range(nobj)
            ]
            ca.wait(refs, num_returns=len(refs), timeout=300)
            if two_sources:
                # a consumer on n2 pulls each object once: the directory now
                # lists two live copies per object
                ca.get(
                    [
                        touch.options(scheduling_strategy=na(n2)).remote(r)
                        for r in refs
                    ],
                    timeout=600,
                )
                time.sleep(1.0)  # obj_copy notifies land
            w = global_worker()
            rc0 = w.head_call("stats")["rpc_counts"]
            s0 = dict(TRANSFER_STATS)
            t0 = time.perf_counter()
            outs = ca.get(refs, timeout=600)  # the driver pulls each object
            dt = time.perf_counter() - t0
            assert len(outs) == nobj and all(o.nbytes == size for o in outs)
            rc1 = w.head_call("stats")["rpc_counts"]
            d = {k: TRANSFER_STATS[k] - s0[k] for k in TRANSFER_STATS}
            head_per_obj = sum(
                rc1.get(m, 0) - rc0.get(m, 0)
                for m in ("obj_locate", "obj_pin")
            ) / nobj
            occupancy = d["window_peak_sum"] / max(1, d["pulls"])
            return nobj * size / dt, occupancy, head_per_obj, d
        finally:
            cluster.shutdown()

    bps, occ, head_rpc, _ = pull_bench(window=1)
    record("transfer pull serial (window=1)", bps / 1e6, "MB/s")
    record("transfer pull serial window occupancy", occ, "rpcs")
    record("transfer pull serial head RPCs/object", head_rpc, "ops")
    bps_w, occ_w, head_rpc_w, _ = pull_bench(window=4)
    record("transfer pull windowed (window=4)", bps_w / 1e6, "MB/s")
    record("transfer pull windowed window occupancy", occ_w, "rpcs")
    record("transfer pull windowed head RPCs/object", head_rpc_w, "ops")
    record("transfer pull windowed speedup", bps_w / bps, "x")
    bps_1, _, _, d1 = pull_bench(window=4, two_sources=True, multi=False)
    record("transfer pull 1-source (2 copies live)", bps_1 / 1e6, "MB/s")
    bps_2, _, _, d2 = pull_bench(window=4, two_sources=True, multi=True)
    record("transfer pull 2-source (2 copies live)", bps_2 / 1e6, "MB/s")
    record("transfer pull multi-source speedup", bps_2 / bps_1, "x")
    record(
        "transfer pull 2-source pulls drawing from both holders",
        d2["multi_source_pulls"], "pulls",
    )

    # --- quantized collective ring (f32 vs int8 vs bf16) ------------------
    from .parallel import collectives as coll

    owns = not ca.is_initialized()
    if owns:
        ca.init(num_cpus=4)

    @ca.remote
    class Rank(coll.CollectiveActorMixin):
        def bench(self, nbytes, reps, group, quantize):
            import numpy as _np

            arr = _np.frombuffer(_np.random.bytes(nbytes), dtype=_np.float32)
            coll.allreduce(arr, group_name=group, quantize=quantize)  # warm
            t0 = time.perf_counter()
            for _ in range(reps):
                out = coll.allreduce(arr, group_name=group, quantize=quantize)
            dt = time.perf_counter() - t0
            assert out.shape == arr.shape
            return reps * nbytes / dt

    from .core.actor import kill as _kill

    # quick still runs 32 MB: below ~16 MB the per-hop fixed costs (loop
    # latency, frame handling) flatten the quantized-vs-f32 ratio into noise
    nbytes = 32 * 1024**2 if quick else 64 * 1024**2
    reps = 2 if quick else 3
    ratios = {}
    for world in (2,) if quick else (2, 4):
        ranks = [Rank.remote() for _ in range(world)]
        coll.create_collective_group(
            ranks, world, list(range(world)), group_name=f"tq{world}"
        )
        base = None
        for qmode in (None, "int8", "bf16"):
            per_rank = ca.get(
                [
                    r.bench.remote(nbytes, reps, f"tq{world}", qmode)
                    for r in ranks
                ],
                timeout=900,
            )
            eff = min(per_rank)
            label = qmode or "f32"
            record(
                f"ring allreduce {label} ({world} ranks, {nbytes >> 20} MB)",
                eff / 1e9, "GB/s per rank",
            )
            if qmode is None:
                base = eff
            else:
                ratios[(world, qmode)] = eff / base
                record(
                    f"ring allreduce {label} speedup vs f32 ({world} ranks)",
                    eff / base, "x",
                )
        coll.destroy_group_on(ranks, f"tq{world}")
        for r in ranks:
            _kill(r)
    if owns:
        ca.shutdown()
    return results


def _sse_request(
    host: str,
    port: int,
    path: str,
    body: Optional[dict] = None,
    timeout: float = 120.0,
) -> Tuple[int, Optional[float], float, int]:
    """One open-loop SSE request over a raw socket.  Returns
    (status, ttft_s or None, total_s, n_events).  TTFT = first `data:` line
    on the wire — what an LLM user actually waits for."""
    import json as _json
    import socket

    t0 = time.perf_counter()
    payload = _json.dumps(body or {}).encode()
    req = (
        f"POST {path} HTTP/1.1\r\nHost: x\r\nAccept: text/event-stream\r\n"
        f"Content-Type: application/json\r\nContent-Length: {len(payload)}\r\n\r\n"
    ).encode() + payload
    s = socket.create_connection((host, port), timeout=timeout)
    try:
        s.settimeout(timeout)
        s.sendall(req)
        buf = b""
        status = 0
        ttft = None
        n_events = 0
        scanned = 0  # resume `data:` counting where the last scan stopped
        while True:
            try:
                chunk = s.recv(65536)
            except OSError:
                break
            if not chunk:
                break
            buf += chunk
            if status == 0 and b"\r\n" in buf:
                try:
                    status = int(buf.split(b"\r\n", 1)[0].split()[1])
                except (IndexError, ValueError):
                    status = 599
                if status != 200:
                    break  # shed/error responses are small: headers+json body
            if ttft is None and b"data:" in buf:
                ttft = time.perf_counter() - t0
            n_events += buf.count(b"data:", scanned)
            # keep a 4-byte overlap: a `data:` straddling two recv()s must
            # count once it completes (an undercount here reads as a
            # dropped request in the drain zero-drop proof)
            scanned = max(0, len(buf) - 4)
        return status, ttft, time.perf_counter() - t0, n_events
    finally:
        s.close()


def _open_loop(
    host: str,
    port: int,
    path: str,
    make_body,
    rate_hz: float,
    duration_s: float,
) -> Tuple[List[Tuple[float, int, Optional[float], float, int]], float]:
    """Open-loop load: requests START at the arrival schedule no matter how
    slow completions are (closed-loop clients would self-throttle and hide
    the saturation knee).  Returns ([(start_s, status, ttft, total,
    n_events)], wall_s) — start_s relative to the trial start, wall_s the
    time until the LAST completion (the honest divisor for served/s when a
    backlog outlives the arrival window)."""
    import threading as _th

    results: List = []
    lock = _th.Lock()
    threads: List[_th.Thread] = []
    t0 = time.perf_counter()

    def one(i: int, start_s: float):
        try:
            r = _sse_request(host, port, path, make_body(i))
        except Exception:
            r = (598, None, 0.0, 0)  # connect/transport failure
        with lock:
            results.append((start_s,) + r)

    i = 0
    while True:
        due = i / rate_hz
        now = time.perf_counter() - t0
        if due > duration_s:
            break
        if now < due:
            time.sleep(due - now)
        t = _th.Thread(
            target=one, args=(i, time.perf_counter() - t0), daemon=True
        )
        t.start()
        threads.append(t)
        i += 1
    for t in threads:
        t.join(timeout=150)
    return results, time.perf_counter() - t0


def _pct(xs: List[float], q: float) -> float:
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs), q * 100))


def run_serve_plane(quick: bool = False, device=None) -> List[Tuple[str, float, str]]:
    """`ca microbenchmark --serve`: the serving-plane envelope.

    (1) Open-loop SSE load through proxy -> router -> ContinuousLLMServer at
        increasing arrival rates: requests/s served, TTFT p50/p99, total p99.
    (2) Admission A/B at ~2x the knee: with the gate ON the proxy sheds
        (429/503 + Retry-After) and the SERVED requests' p99 stays bounded;
        OFF, everything queues and p99 grows with the backlog.
    (3) Prefix-cache A/B: shared-system-prompt traffic vs distinct prompts —
        hits skip the prefix prefill, measured as the TTFT drop.
    (4) Drain-under-load: 2-node cluster, drain the replica-hosting node
        mid-traffic — zero dropped requests, replacement replicas spawn, and
        TTFT p99 during the drain stays within ~2x steady state.

    The LLM replicas run on `device` (None: the card, REPLICA_GPUS of it
    each; without one this raises before any session starts)."""
    import socket

    from . import serve
    from ._device import resolve_device
    from .core import api as ca
    from .core.actor import get_actor
    from .llm.processor import ProcessorConfig
    from .llm.serve_llm import build_continuous_llm_deployment
    from .serve.config import AdmissionPolicy
    from .serve.controller import CONTROLLER_NAME

    results: List[Tuple[str, float, str]] = []

    def record(name: str, value: float, unit: str):
        results.append((name, value, unit))
        print(f"{name}: {value:,.2f} {unit}")

    def free_port() -> int:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    host = "127.0.0.1"
    gpus = REPLICA_GPUS if resolve_device(device).type == "cuda" else 0.0

    # ---------------- phase 1+2: envelope + shedding (single-node) --------
    owns = not ca.is_initialized()
    if owns:
        ca.init(num_cpus=4)
    port = free_port()
    serve.start(host=host, port=port)
    slots = 4
    mnt = 8 if quick else 16
    cfg = ProcessorConfig(max_prompt_len=64, max_new_tokens=mnt)
    app = build_continuous_llm_deployment(
        cfg, slots=slots, num_replicas=1, sse_ingress=True,
        admission=AdmissionPolicy(max_queue_depth=2 * slots),
        num_gpus=gpus, device=device,
    )
    serve.run(app, name="llmserve", route_prefix="/llmserve")
    time.sleep(1.0)  # proxy route refresh picks up the admission policy

    def body(i: int) -> dict:
        return {"prompt": f"request {i:04d} " + "x" * 16, "max_new_tokens": mnt}

    # warmup: compile prefill/decode programs before any timing
    for i in range(2):
        st, _, _, _ = _sse_request(host, port, "/llmserve", body(i))
        assert st == 200, f"warmup request failed: HTTP {st}"
    # knee estimate from a short closed-loop burst
    t0 = time.perf_counter()
    n_burst = 6
    for i in range(n_burst):
        _sse_request(host, port, "/llmserve", body(100 + i))
    svc = n_burst / (time.perf_counter() - t0)  # closed-loop service rate
    # continuous batching shares one decode loop, so capacity is closer to
    # the closed-loop rate than to slots x it; "below knee" = ~0.7x that
    base_rate = max(0.5, svc * 0.7)
    dur = 5.0 if quick else 8.0

    def trial(rate: float, label: str):
        rs, wall = _open_loop(host, port, "/llmserve", body, rate, dur)
        ok = [r for r in rs if r[1] == 200]
        shed = [r for r in rs if r[1] in (429, 503)]
        err = [r for r in rs if r[1] not in (200, 429, 503)]
        ttfts = [r[2] for r in ok if r[2] is not None]
        record(f"serve {label} offered", rate, "req/s")
        record(f"serve {label} served", len(ok) / max(wall, 1e-9), "req/s")
        record(f"serve {label} shed", float(len(shed)), "req")
        record(f"serve {label} errors", float(len(err)), "req")
        record(f"serve {label} TTFT p50", _pct(ttfts, 0.5) * 1e3, "ms")
        record(f"serve {label} TTFT p99", _pct(ttfts, 0.99) * 1e3, "ms")
        record(
            f"serve {label} total p99",
            _pct([r[3] for r in ok], 0.99) * 1e3, "ms",
        )
        return rs

    trial(base_rate, "below-knee")
    over = max(2.0, svc * 2.5)
    trial(over, "overload admission-on")
    # admission OFF at the same overload: same code, config-only redeploy
    app_off = build_continuous_llm_deployment(
        cfg, slots=slots, num_replicas=1, sse_ingress=True, admission=None,
        num_gpus=gpus, device=device,
    )
    serve.run(app_off, name="llmserve", route_prefix="/llmserve")
    time.sleep(1.5)  # proxy refresh drops the policy
    trial(over, "overload admission-off")

    # ---------------- phase 3: prefix-cache A/B ---------------------------
    pfx_cfg = ProcessorConfig(
        max_prompt_len=256, max_new_tokens=8, prefix_cache_entries=8,
        prefix_block=16,
    )
    pfx_app = build_continuous_llm_deployment(
        pfx_cfg, slots=slots, num_replicas=1, sse_ingress=True,
        name="LLMPrefix", num_gpus=gpus, device=device,
    )
    serve.run(pfx_app, name="llmpfx", route_prefix="/llmpfx")
    system = "You are a terse assistant. " * 9  # ~240 chars -> 240 byte-tokens
    n_seq = 6 if quick else 12

    def seq_ttft(mk_body) -> List[float]:
        out = []
        for i in range(n_seq):
            st, ttft, _, _ = _sse_request(host, port, "/llmpfx", mk_body(i))
            if st == 200 and ttft is not None:
                out.append(ttft)
        return out

    # warm the programs AND seed the cache with the shared prefix
    seq_ttft(lambda i: {"prompt": system + f"warm {i}", "max_new_tokens": 8})
    shared = seq_ttft(lambda i: {"prompt": system + f"q{i:03d}", "max_new_tokens": 8})
    distinct = seq_ttft(
        lambda i: {"prompt": f"{i:03d} " * 60 + f"q{i}", "max_new_tokens": 8}
    )
    record("serve prefix shared TTFT p50", _pct(shared, 0.5) * 1e3, "ms")
    record("serve prefix distinct TTFT p50", _pct(distinct, 0.5) * 1e3, "ms")
    if shared and distinct:
        record(
            "serve prefix TTFT speedup",
            _pct(distinct, 0.5) / max(_pct(shared, 0.5), 1e-9), "x",
        )
    try:
        from .util.state import serve_plane

        time.sleep(2.5)  # engine-metrics sync + flush tick
        counters = serve_plane()["counters"]
        record(
            "serve prefix cache hits",
            float(counters.get("prefix_hits_total", 0)), "req",
        )
        record(
            "serve prefix tokens reused",
            float(counters.get("prefix_tokens_reused_total", 0)), "tok",
        )
    except Exception as e:
        print(f"(prefix counters unavailable: {e!r})")
    serve.delete("llmpfx")
    serve.delete("llmserve")
    serve.shutdown()
    if owns:
        ca.shutdown()

    # ---------------- phase 4: drain under load (multi-node) --------------
    from .cluster_utils import Cluster

    c = Cluster(head_resources={"CPU": 1})
    c.add_node(num_cpus=3)
    c.add_node(num_cpus=3)
    c.connect()
    c.wait_for_nodes(3)
    try:
        port2 = free_port()
        serve.start(host=host, port=port2)

        @serve.deployment(num_replicas=2, max_ongoing_requests=8)
        class TokenStream:
            def __call__(self, request):
                n = 20
                for i in range(n):
                    time.sleep(0.05)
                    yield {"token": i}

        serve.run(TokenStream.bind(), name="drainapp", route_prefix="/drainapp")
        time.sleep(1.0)
        # warm
        st, _, _, ne = _sse_request(host, port2, "/drainapp", {})
        assert st == 200 and ne >= 20, f"warmup stream failed: {st}/{ne}"

        ctrl = get_actor(CONTROLLER_NAME)
        info = ca.get(ctrl.serve_plane_info.remote(), timeout=10)
        reps = info["drainapp"]["TokenStream"]["replicas"]
        victim = next(
            n for n in (r["node_id"] for r in reps.values()) if n and n != "n0"
        )

        rate = 4.0 if quick else 6.0
        dur2 = 10.0 if quick else 14.0
        drain_at = 3.0
        drained = {}

        def drainer():
            time.sleep(drain_at)
            drained["t"] = time.perf_counter()
            ca.drain_node(victim, reason="preemption", deadline_s=30.0)

        import threading as _th

        th = _th.Thread(target=drainer, daemon=True)
        t_start = time.perf_counter()
        th.start()
        rs, _wall = _open_loop(host, port2, "/drainapp", lambda i: {}, rate, dur2)
        th.join()
        ok = [r for r in rs if r[1] == 200 and r[4] >= 20]
        bad = [r for r in rs if r not in ok]
        # split steady-state vs during-drain by request START time
        cut = drained["t"] - t_start
        steady = [r[2] for r in ok if r[2] is not None and r[0] < cut]
        during = [r[2] for r in ok if r[2] is not None and r[0] >= cut]
        record("serve drain requests", float(len(rs)), "req")
        record("serve drain dropped/errored", float(len(bad)), "req")
        record("serve drain TTFT p99 steady", _pct(steady, 0.99) * 1e3, "ms")
        record("serve drain TTFT p99 during", _pct(during, 0.99) * 1e3, "ms")
        if steady and during:
            record(
                "serve drain TTFT p99 ratio",
                _pct(during, 0.99) / max(_pct(steady, 0.99), 1e-9), "x",
            )
        info = ca.get(ctrl.serve_plane_info.remote(), timeout=10)
        d = info["drainapp"]["TokenStream"]
        record(
            "serve drain final active replicas",
            float(d["actual_replicas"] - len(d["draining_replicas"])), "replicas",
        )
        serve.delete("drainapp")
        serve.shutdown()
    finally:
        c.shutdown()
    return results


def run_dag_plane(quick: bool = False, device=None) -> List[Tuple[str, float, str]]:
    """`ca microbenchmark --dag`: compiled-DAG plane A/B.

    (1) Actor-call A/B on one actor: per-call RPC latency (sync p50) and
        async throughput vs compiled-DAG tick latency over pre-opened shm
        channels (driver write -> futex wake -> compute -> futex wake ->
        driver read; zero RPCs in steady state) and pipelined throughput at
        max_inflight_executions.
    (2) 3-actor chain A/B: chained RPC per item vs one compiled graph.
    (3) Serve TTFT A/B: ContinuousLLMServer SSE below the knee with
        config.serve_compiled_dag OFF vs ON — a fresh cluster per mode,
        env-toggled so the proxy process inherits the setting.  The replica
        runs on `device` (None: the card; without one this raises before
        any session starts)."""
    import socket

    from ._device import resolve_device
    from .core import api as ca
    from .dag import InputNode

    resolve_device(device)

    results: List[Tuple[str, float, str]] = []

    def record(name: str, value: float, unit: str):
        results.append((name, value, unit))
        print(f"{name}: {value:,.2f} {unit}")

    # ---------------- phase 1+2: actor-call / chain A/B -------------------
    owns = not ca.is_initialized()
    if owns:
        ca.init(num_cpus=4)

    @ca.remote
    class Relay:
        def step(self, x):
            return x

    actors = [Relay.remote() for _ in range(3)]
    a = actors[0]
    ca.get([x.step.remote(0) for x in actors])

    n_lat = 200 if quick else 1000
    n_thru = 2000 if quick else 10000

    def sync_p50(fn) -> float:
        lats = []
        for i in range(n_lat):
            t0 = time.perf_counter()
            fn(i)
            lats.append(time.perf_counter() - t0)
        return _pct(lats, 0.5)

    rpc_p50 = sync_p50(lambda i: ca.get(a.step.remote(i)))
    record("dag rpc actor-call sync p50", rpc_p50 * 1e6, "us")
    record(
        "dag rpc actor-call async",
        _rate(n_thru, lambda: ca.get([a.step.remote(i) for i in range(n_thru)])),
        "/s",
    )

    inflight = 8
    with InputNode() as inp:
        node = a.step.bind(inp)
    cd = node.experimental_compile(max_inflight_executions=inflight)
    assert cd.execute(0).get() == 0  # warm channels + loop
    dag_p50 = sync_p50(lambda i: cd.execute(i).get())
    record("dag compiled tick sync p50", dag_p50 * 1e6, "us")
    record("dag compiled vs rpc sync latency", rpc_p50 / max(dag_p50, 1e-9), "x")

    def pipelined():
        refs = []
        for i in range(n_thru):
            refs.append(cd.execute(i))
            if len(refs) >= inflight:
                refs.pop(0).get()
        while refs:
            refs.pop(0).get()

    record("dag compiled pipelined", _rate(n_thru, pipelined), "/s")
    cd.teardown()

    # 3-hop chain: driver -> a -> b -> c -> driver
    rpc3_p50 = sync_p50(
        lambda i: ca.get(
            actors[2].step.remote(actors[1].step.remote(actors[0].step.remote(i)))
        )
    )
    record("dag rpc 3-actor chain sync p50", rpc3_p50 * 1e6, "us")
    with InputNode() as inp:
        x = actors[0].step.bind(inp)
        x = actors[1].step.bind(x)
        x = actors[2].step.bind(x)
    cd3 = x.experimental_compile(max_inflight_executions=inflight)
    assert cd3.execute(0).get() == 0
    dag3_p50 = sync_p50(lambda i: cd3.execute(i).get())
    record("dag compiled 3-actor chain sync p50", dag3_p50 * 1e6, "us")
    record(
        "dag compiled vs rpc 3-actor latency", rpc3_p50 / max(dag3_p50, 1e-9), "x"
    )
    cd3.teardown()
    from .core.actor import kill as _kill

    for x in actors:
        _kill(x)
    if owns:
        ca.shutdown()

    # ---------------- phase 3: serve TTFT A/B -----------------------------
    if not owns:
        print("(serve TTFT A/B skipped: caller owns the cluster; the A/B "
              "needs a fresh cluster per mode)")
        return results
    from . import serve
    from .llm.processor import ProcessorConfig
    from .llm.serve_llm import build_continuous_llm_deployment

    def free_port() -> int:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        p = s.getsockname()[1]
        s.close()
        return p

    host = "127.0.0.1"
    mnt = 8 if quick else 16
    n_req = 8 if quick else 16
    prev = os.environ.get("CA_SERVE_COMPILED_DAG")
    try:
        for label, flag in (("rpc-stream", "0"), ("compiled", "1")):
            # env-toggled BEFORE init so the proxy's process inherits it
            os.environ["CA_SERVE_COMPILED_DAG"] = flag
            ca.init(num_cpus=4)
            port = free_port()
            serve.start(host=host, port=port)
            cfg = ProcessorConfig(max_prompt_len=64, max_new_tokens=mnt)
            app = build_continuous_llm_deployment(
                cfg, slots=4, num_replicas=1, sse_ingress=True, device=device,
            )
            serve.run(app, name="llmdag", route_prefix="/llmdag")
            time.sleep(1.0)

            def body(i: int) -> dict:
                return {
                    "prompt": f"request {i:04d} " + "x" * 16,
                    "max_new_tokens": mnt,
                }

            for i in range(2):  # compile prefill/decode before timing
                st, _, _, _ = _sse_request(host, port, "/llmdag", body(i))
                assert st == 200, f"warmup request failed: HTTP {st}"
            ttfts, events = [], 0
            for i in range(n_req):
                st, ttft, _, ne = _sse_request(host, port, "/llmdag", body(10 + i))
                if st == 200 and ttft is not None:
                    ttfts.append(ttft)
                    events += ne
            record(f"dag serve {label} TTFT p50", _pct(ttfts, 0.5) * 1e3, "ms")
            record(f"dag serve {label} TTFT p99", _pct(ttfts, 0.99) * 1e3, "ms")
            record(f"dag serve {label} events", float(events), "ev")
            serve.delete("llmdag")
            serve.shutdown()
            ca.shutdown()
    finally:
        if prev is None:
            os.environ.pop("CA_SERVE_COMPILED_DAG", None)
        else:
            os.environ["CA_SERVE_COMPILED_DAG"] = prev
    return results


def run_partition_chaos(quick: bool = False, seed: int = 1234) -> List[Tuple[str, float, str]]:
    """`ca microbenchmark --partition`: the partition-tolerance timeline.

    A head<->node blackhole lands mid-workload (side-effect tasks that
    commit a uniquely-keyed KV write per ATTEMPT).  Measured: how long the
    head takes to DETECT the silent node (heartbeat timeout -> death
    verdict), how many stale-incarnation RPCs the FENCE refused, and how
    long after the scheduled HEAL the node is back alive at a fresh
    incarnation.  Structural proofs: every logical task committed exactly
    once (zombie commits were fenced, not duplicated), and the healed node
    carries zero grants minted before the verdict."""
    from .cluster_utils import Cluster
    from .core import api as ca
    from .core.config import CAConfig
    from .core.worker import global_worker
    from .util.chaos import NetworkPartition

    results: List[Tuple[str, float, str]] = []

    def record(name: str, value: float, unit: str):
        results.append((name, value, unit))
        print(f"{name}: {value:,.2f} {unit}")

    print(f"partition chaos seed={seed} (replay: CA_PARTITION_SEED={seed})")
    cfg = CAConfig()
    cfg.health_check_period_s = 0.5
    cfg.health_check_failure_threshold = 3
    n_tasks = 6 if quick else 10
    duration = 6.0 if quick else 8.0
    c = Cluster(head_resources={"CPU": 2}, config=cfg)
    nid = c.add_node(num_cpus=2)
    c.connect()
    try:
        c.wait_for_nodes(2)
        w = global_worker()

        def node_row():
            return next(
                (n for n in ca.nodes() if n["node_id"] == nid), None
            )

        inc0 = node_row()["incarnation"]

        @ca.remote(max_retries=5)
        def commit(i, sleep_s):
            import os as _os
            import time as _t

            from cluster_anywhere_tpu_torch.core.worker import global_worker as _gw

            _t.sleep(sleep_s)
            # the side effect: a fenced, attempt-keyed KV commit — a zombie
            # attempt's stamp is stale after the verdict, so it is REFUSED
            _gw().head_call(
                "kv_put", ns="chaos_se",
                key=f"{i}:{_os.urandom(4).hex()}", value=b"1",
            )
            return i

        refs = [commit.remote(i, 3.0) for i in range(n_tasks)]
        time.sleep(0.3)  # tasks land on both nodes before the cut
        part = NetworkPartition(nid, "n0", duration_s=duration, seed=seed).start()
        t_cut = part.epoch + part.start_after_s
        # --- detect: heartbeat silence -> death verdict -------------------
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            row = node_row()
            if row is None or not row["alive"]:
                break
            time.sleep(0.05)
        t_detect = time.time()
        record("partition detect", t_detect - t_cut, "s")
        # --- resubmit: the workload survives on the other side ------------
        assert ca.get(refs, timeout=120) == list(range(n_tasks))
        # --- heal: schedule re-opens the link; node rejoins fresh ---------
        part.wait_heal()
        deadline = time.monotonic() + 30
        row = None
        while time.monotonic() < deadline:
            row = node_row()
            if row is not None and row["alive"] and row["incarnation"] > inc0:
                break
            time.sleep(0.1)
        assert row is not None and row["incarnation"] > inc0, (
            f"node never rejoined fresh (seed={seed}): {row}"
        )
        record("partition heal->rejoin", time.time() - part.heals_at(), "s")
        record("partition incarnation delta", row["incarnation"] - inc0, "x")
        stats = w.head_call("stats")["stats"]
        record("partition fenced RPCs", float(stats.get("fenced_rpcs", 0)), "ops")
        # --- at-most-once: one commit per logical task --------------------
        keys = w.head_call("kv_keys", ns="chaos_se")["keys"]
        per_task = [len([k for k in keys if k.startswith(f"{i}:")]) for i in range(n_tasks)]
        dups = sum(max(0, n - 1) for n in per_task)
        missing = sum(1 for n in per_task if n == 0)
        record("partition duplicate commits", float(dups), "tasks")
        record("partition missing commits", float(missing), "tasks")
        # --- zombie grants: the healed node's blocks start empty ----------
        used = sum(
            b.get("used", 0) for b in (row.get("lease_blocks") or {}).values()
        )
        record("partition zombie grants after heal", float(used), "grants")
        part.clear()
    finally:
        c.shutdown()
    return results


def run_ha_plane(quick: bool = False) -> List[Tuple[str, float, str]]:
    """`ca microbenchmark --ha`: the head-failover timeline.

    A warm standby replicates the active head's registry; the active head is
    SIGKILLed mid-workload (side-effect tasks in flight, synchronously
    replicated "acked" KV writes committed beforehand).  Measured: how long
    from the kill until a standby promotes (detect -> promote), and until
    the driver's first successful operation against the successor.
    Structural proofs: every acked KV write survives (loss = 0), every
    logical side-effect task committed exactly once (dup = 0), and the
    successor's epoch is strictly above the dead head's."""
    from .cluster_utils import Cluster
    from .core import api as ca
    from .core.config import CAConfig
    from .core.worker import global_worker

    results: List[Tuple[str, float, str]] = []

    def record(name: str, value: float, unit: str):
        results.append((name, value, unit))
        print(f"{name}: {value:,.3f} {unit}")

    cfg = CAConfig()
    cfg.health_check_period_s = 0.5
    cfg.health_check_failure_threshold = 3
    cfg.ha_failover_grace_s = 1.0
    n_keys = 20 if quick else 50
    n_tasks = 6 if quick else 10
    c = Cluster(head_resources={"CPU": 2}, config=cfg)
    nid = c.add_node(num_cpus=2)
    c.add_standby(rank=0)
    c.connect()
    try:
        c.wait_for_nodes(2)
        w = global_worker()
        # wait for the standby to subscribe: only then are KV puts "acked"
        # (synchronously standby-resident before the reply)
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline:
            if w.head_call("ha_status").get("standbys"):
                break
            time.sleep(0.05)
        else:
            raise TimeoutError("standby never subscribed to the repl stream")
        for i in range(n_keys):
            w.head_call("kv_put", ns="ha_acked", key=f"k{i}", value=b"v")

        @ca.remote(max_retries=5)
        def commit(i, sleep_s):
            import os as _os
            import time as _t

            from cluster_anywhere_tpu_torch.core.worker import global_worker as _gw

            _t.sleep(sleep_s)
            # attempt-keyed side effect: a duplicate execution would show up
            # as a second key with the same logical prefix
            _gw().head_call(
                "kv_put", ns="ha_se",
                key=f"{i}:{_os.urandom(4).hex()}", value=b"1",
            )
            return i

        refs = [commit.remote(i, 2.0) for i in range(n_tasks)]
        time.sleep(0.3)  # tasks are in flight when the head dies
        # --- SIGKILL the active head; the standby detects and promotes ----
        t_kill = time.time()
        c.kill_head()
        c.wait_promoted(timeout=45)
        record("ha detect->promote", time.time() - t_kill, "s")
        # --- first successful driver op through the failover ring ---------
        deadline = time.monotonic() + 45
        while True:
            try:
                w.head_call("kv_get", ns="ha_acked", key="k0")
                break
            except Exception:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.05)
        record("ha detect->promote->first op", time.time() - t_kill, "s")
        # --- acked-KV loss: every replicated write survived ----------------
        keys = w.head_call("kv_keys", ns="ha_acked")["keys"]
        lost = sum(1 for i in range(n_keys) if f"k{i}" not in keys)
        record("ha acked KV loss", float(lost), "keys")
        # --- the workload drains to completion on the successor ------------
        assert sorted(ca.get(refs, timeout=120)) == list(range(n_tasks))
        se = w.head_call("kv_keys", ns="ha_se")["keys"]
        per_task = [
            len([k for k in se if k.startswith(f"{i}:")]) for i in range(n_tasks)
        ]
        record(
            "ha duplicate side effects",
            float(sum(max(0, n - 1) for n in per_task)), "tasks",
        )
        record(
            "ha missing side effects",
            float(sum(1 for n in per_task if n == 0)), "tasks",
        )
        st = w.head_call("ha_status")
        record("ha promotion epoch bump", float(st["epoch"] - 1), "x")
        record("ha repl lag", float(st.get("repl_lag") or 0), "records")
        assert st["role"] == "active" and st["epoch"] >= 2
        # keep the surviving node honest: it must still be schedulable
        assert any(
            n["node_id"] == nid and n["alive"] for n in ca.nodes()
        ), "agent never re-anchored to the promoted head"
    finally:
        c.shutdown()
    return results


def head_saturation(quick: bool = False) -> List[Tuple[str, float, str]]:
    """`ca microbenchmark --saturation`: find where the single head's asyncio
    loop saturates (the directory/refcount/lease/pubsub planes all ride one
    loop; this records the envelope that says whether ownership needs
    distributing).

    Two sweeps:
    - control-plane ops/s vs concurrent driver connections (KV round-trips:
      the cheapest RPC, so the number is the loop's dispatch ceiling);
    - the same at the knee while K idle agent nodes heartbeat, measuring how
      much node-table upkeep steals from the dispatch budget.
    """
    import threading

    from .cluster_utils import Cluster
    from .core.protocol import BlockingClient

    results: List[Tuple[str, float, str]] = []

    def record(name: str, value: float, unit: str):
        results.append((name, value, unit))
        print(f"{name}: {value:,.1f} {unit}")

    cluster = Cluster(head_resources={"CPU": 2})
    try:
        n_per = 200 if quick else 1000

        def hammer(out, i):
            conn = BlockingClient(cluster.head_tcp)
            try:
                # "probe" role: served like a client but without driver-exit
                # or worker-table semantics
                conn.call("register", role="probe", client_id=f"sat{i}")
                t0 = time.perf_counter()
                for k in range(n_per):
                    conn.call("kv_put", key=f"sat{i}/{k % 8}", value=b"x")
                out[i] = n_per / (time.perf_counter() - t0)
            finally:
                conn.close()

        def sweep(m: int) -> float:
            out = [0.0] * m
            threads = [
                threading.Thread(target=hammer, args=(out, i)) for i in range(m)
            ]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            elapsed = time.perf_counter() - t0
            if not all(out):
                # a dead hammer thread exactly at the knee would otherwise be
                # silently credited with its full op count
                raise RuntimeError(f"{out.count(0.0)} of {m} probe clients failed")
            return m * n_per / elapsed

        for m in (1, 2, 4, 8, 16):
            record(f"head kv ops ({m} clients)", sweep(m), "/s")

        # node-scale: idle agents heartbeating while 8 clients hammer
        def wait_nodes(n):
            probe = BlockingClient(cluster.head_tcp)
            try:
                probe.call("register", role="probe", client_id="satwait")
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    alive = [
                        x for x in probe.call("nodes")["nodes"] if x["alive"]
                    ]
                    if len(alive) >= n:
                        return
                    time.sleep(0.1)
                raise TimeoutError(f"cluster did not reach {n} nodes")
            finally:
                probe.close()

        for k in (4, 16):
            for _ in range(k - (len(cluster._agents))):
                cluster.add_node(num_cpus=1)
            wait_nodes(k + 1)
            record(f"head kv ops (8 clients, {k} nodes heartbeating)", sweep(8), "/s")
    finally:
        cluster.shutdown()
    return results


def run_train_elastic(quick: bool = False) -> List[Tuple[str, float, str]]:
    """`ca microbenchmark --train-elastic`: A/B the preemption-elastic
    train plane.

    Both arms run the SAME training loop (periodic checkpoint every
    `ckpt_every` steps, cooperative `train.should_checkpoint()` saves) as a
    2-worker gang across two 1-CPU nodes, and preempt one worker node
    mid-run (`ca.drain_node(reason="preemption")`):

    - proactive (drain_aware=True, max_failures=0): the controller sees the
      warning, barriers a checkpoint at the next step boundary, and rebuilds
      on the survivor — budget-exempt, so max_failures=0 still succeeds.
    - reactive (drain_aware=False, max_failures=1): the controller only
      learns at the drain-deadline kill (poll failure) and resumes from the
      last PERIODIC checkpoint, re-running every step since it.

    Rows: preempt-warning -> training-resumed latency and steps lost
    (re-executed) per arm.  Steps lost counts from delivered reports, so it
    is a floor for the reactive arm (reports between the last poll and the
    kill die with the worker)."""
    import tempfile
    import threading

    from .cluster_utils import Cluster
    from .core import api as ca

    results: List[Tuple[str, float, str]] = []

    def record(name: str, value: float, unit: str):
        results.append((name, value, unit))
        print(f"{name}: {value:,.2f} {unit}")

    total = 40 if quick else 70
    step_s = 0.15
    ckpt_every = 10
    preempt_at = 8
    reactive_deadline_s = 3.0

    def loop(config):
        import time as _time

        import numpy as _np

        from cluster_anywhere_tpu_torch import train
        from cluster_anywhere_tpu_torch.train import Checkpoint

        ctx = train.get_context()
        ck = train.get_checkpoint()
        start = 0
        if ck is not None:
            start = int(ck.load_pytree_sharded()["step"]) + 1
        resumed = start > 0
        for step in range(start, config["total"]):
            _time.sleep(config["step_s"])  # the "compute"
            if (
                step == config["preempt_at"]
                and ctx.get_world_rank() == 0
                and not resumed
            ):
                open(config["go"], "w").close()  # arm the preempter
            save = (
                train.should_checkpoint()
                or step % config["ckpt_every"] == config["ckpt_every"] - 1
                or step == config["total"] - 1
            )
            metrics = {"step": step, "t": _time.time(), "resumed": resumed}
            if save:
                c = Checkpoint(train.shared_checkpoint_dir(step))
                c.save_pytree_sharded(
                    {"step": _np.int64(step)},
                    process_index=ctx.get_world_rank(),
                    num_processes=ctx.get_world_size(),
                )
                train.report(metrics, checkpoint=c)
            else:
                train.report(metrics)

    def arm(drain_aware: bool) -> Tuple[float, float]:
        from .train import (
            DataParallelTrainer,
            FailureConfig,
            RunConfig,
            ScalingConfig,
        )

        cluster = Cluster(head_resources={"CPU": 0})
        n1 = cluster.add_node(num_cpus=1)
        cluster.add_node(num_cpus=1)
        cluster.connect()
        try:
            cluster.wait_for_nodes(3)
            tmp = tempfile.mkdtemp(prefix="ca_train_elastic_")
            go = os.path.join(tmp, "go")
            warn_t: Dict[str, float] = {}

            def preempter():
                while not os.path.exists(go):
                    time.sleep(0.02)
                warn_t["t"] = time.time()
                ca.drain_node(
                    n1,
                    reason="preemption",
                    deadline_s=30.0 if drain_aware else reactive_deadline_s,
                )

            th = threading.Thread(target=preempter, daemon=True)
            th.start()
            res = DataParallelTrainer(
                loop,
                train_loop_config={
                    "total": total,
                    "step_s": step_s,
                    "ckpt_every": ckpt_every,
                    "preempt_at": preempt_at,
                    "go": go,
                },
                # the gang's 1-CPU nodes have no GPU: the loop is a sleep
                scaling_config=ScalingConfig(
                    num_workers=2, min_workers=1, max_workers=2, use_gpu=False
                ),
                run_config=RunConfig(
                    name="proactive" if drain_aware else "reactive",
                    storage_path=tmp,
                    failure_config=FailureConfig(
                        max_failures=0 if drain_aware else 1,
                        drain_aware=drain_aware,
                    ),
                ),
            ).fit()
            th.join(timeout=10)
            hist = res.metrics_history
            pre = [m for m in hist if not m["resumed"]]
            post = [m for m in hist if m["resumed"]]
            if not pre or not post:
                raise RuntimeError(
                    f"arm drain_aware={drain_aware}: no restart observed "
                    f"(pre={len(pre)}, post={len(post)})"
                )
            latency = min(m["t"] for m in post) - warn_t["t"]
            steps_lost = max(m["step"] for m in pre) - (
                min(m["step"] for m in post) - 1
            )
            return latency, float(max(0, steps_lost))
        finally:
            cluster.shutdown()

    lat_a, lost_a = arm(drain_aware=True)
    record("train-elastic proactive restart latency", lat_a, "s")
    record("train-elastic proactive steps lost", lost_a, "steps")
    lat_b, lost_b = arm(drain_aware=False)
    record("train-elastic reactive restart latency", lat_b, "s")
    record("train-elastic reactive steps lost", lost_b, "steps")
    return results


def run_obsplane(quick: bool = False) -> List[Tuple[str, float, str]]:
    """`ca microbenchmark --obsplane`: the flight-recorder cost model.

    Process-local rows: armed `record()` events/s (the full cost — dict
    build, trace probe, lock, ring append), the disabled-path gate rate
    (`REC is None`: one attribute load + branch, the off switch's whole
    cost), and the journal's memory footprint with the default ring at
    cap.  Cluster rows: simple-task round-trip throughput with
    flightrec_plane on vs off — the acceptance A/B: disabled within
    noise, enabled cost bounded by the journal's own record rate."""
    from .cluster_utils import Cluster
    from .core import api as ca
    from .core.config import CAConfig
    from .util import flightrec

    results: List[Tuple[str, float, str]] = []

    def record(name: str, value: float, unit: str):
        results.append((name, value, unit))
        print(f"{name}: {value:,.1f} {unit}")

    # --- process-local: the record path and the off switch ---------------
    n = 50_000 if quick else 400_000
    saved = flightrec.REC
    try:
        rec = flightrec.FlightRecorder(cap=4096, node_id="bench", proc="mb")
        flightrec.REC = rec
        t0 = time.perf_counter()
        for i in range(n):
            rec.record("dag", "dag_tick", idx=i)
        dt = time.perf_counter() - t0
        record("obsplane armed record events/s", n / dt, "/s")
        # the ring rotated many times over: this is the steady-state
        # footprint of a FULL default-cap journal
        record(
            "obsplane journal memory at cap", float(rec.memory_bytes()),
            "bytes",
        )
        st = rec.stats()
        assert st["len"] == st["cap"] and st["dropped"] == n - st["cap"]

        flightrec.REC = None
        acc = 0
        t0 = time.perf_counter()
        for i in range(n):
            if flightrec.REC is not None:  # the disabled hot-path gate
                flightrec.REC.record("dag", "dag_tick", idx=i)
            acc += i
        dt_off = time.perf_counter() - t0
        record("obsplane disabled gate checks/s", n / dt_off, "/s")
        record(
            "obsplane disabled ns/check", dt_off / n * 1e9, "ns",
        )
    finally:
        flightrec.REC = saved

    # --- cluster A/B: task throughput with the plane on vs off -----------
    def tput(plane_on: bool) -> float:
        cfg = CAConfig()
        cfg.flightrec_plane = plane_on
        cluster = Cluster(head_resources={"CPU": 2}, config=cfg)
        cluster.connect()
        try:
            @ca.remote
            def echo(i):
                return i

            ca.get([echo.remote(i) for i in range(20)], timeout=120)
            m = 200 if quick else 1000
            t0 = time.perf_counter()
            ca.get([echo.remote(i) for i in range(m)], timeout=300)
            return m / (time.perf_counter() - t0)
        finally:
            cluster.shutdown()

    # two alternating rounds, best-of-each: the FIRST cluster a process
    # starts pays one-time warmup (imports, forkserver) that would be
    # misread as plane overhead if one arm always went first
    on = max(tput(True), tput(True))
    off = max(tput(False), tput(False))
    record("obsplane tasks/s flightrec on", on, "/s")
    record("obsplane tasks/s flightrec off", off, "/s")
    record("obsplane off/on throughput ratio", off / max(on, 1e-9), "")
    return results


def main(
    quick: bool = False,
    saturation: bool = False,
    multiclient: bool = False,
    scalability: bool = False,
    collective: bool = False,
    lease_plane: bool = False,
    owner_plane: bool = False,
    transfer: bool = False,
    serve_plane: bool = False,
    train_elastic: bool = False,
    partition: bool = False,
    obsplane: bool = False,
):
    if saturation:
        head_saturation(quick=quick)
    elif multiclient:
        run_multiclient(quick=quick)
    elif scalability:
        run_scalability(quick=quick)
    elif collective:
        run_collective_bw(quick=quick)
    elif lease_plane:
        run_lease_plane(quick=quick)
    elif owner_plane:
        run_owner_plane(quick=quick)
    elif transfer:
        run_transfer_plane(quick=quick)
    elif serve_plane:
        run_serve_plane(quick=quick)
    elif train_elastic:
        run_train_elastic(quick=quick)
    elif partition:
        run_partition_chaos(quick=quick)
    elif obsplane:
        run_obsplane(quick=quick)
    else:
        run_microbenchmarks(quick=quick)


if __name__ == "__main__":
    import sys

    main(
        quick="--quick" in sys.argv,
        saturation="--saturation" in sys.argv,
        multiclient="--multi" in sys.argv,
        scalability="--scalability" in sys.argv,
        collective="--collective" in sys.argv,
        lease_plane="--lease-plane" in sys.argv,
        owner_plane="--owner-plane" in sys.argv,
        transfer="--transfer" in sys.argv,
        serve_plane="--serve" in sys.argv,
        train_elastic="--train-elastic" in sys.argv,
        partition="--partition" in sys.argv,
        obsplane="--obsplane" in sys.argv,
    )
