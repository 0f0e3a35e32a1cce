"""Network-chaos plane: deterministic per-link fault injection for the frame
protocol (the partition/straggler analogue of RpcChaos, which only models an
RPC that errors CLEANLY).

Real control planes die to the failures RpcChaos cannot express: a network
partition where frames vanish and connections HANG instead of erroring, a
straggling link that delivers every frame late, a flapping cross-zone hop.
This module injects exactly those, per directed link (src-node, dst-node),
from a seeded schedule — the same seed and spec always produce the same
event sequence, so a chaos failure replays.

Policies live in a spec string (config.testing_net_chaos / the
CA_TESTING_NET_CHAOS env var, installed at process start; `ca chaos set`
broadcasts one cluster-wide at runtime through the head):

    seed=7;epoch=1722.5;n0<>node1:blackhole@1.0+8.0;n0>node2:delay=0.05

Clauses (`;`-separated):
  seed=N              deterministic schedule seed (default 0)
  epoch=FLOAT         wall-clock anchor for window offsets; every process
                      given the same epoch agrees on when windows open even
                      though they installed the spec at different times
                      (default: install time — fine for one-process tests)
  SRC>DST:actions     one directed link; SRC<>DST installs both directions
with comma-separated actions:
  blackhole           drop every frame, forever
  blackhole@S+D       drop frames in the window [S, S+D) seconds from epoch
  delay=SEC           per-frame latency (straggler link; ordering preserved)
  jitter=SEC          extra per-frame latency in [0, SEC), drawn from the
                      seeded per-link stream
  flap=UP/DOWN[@S]    from S (default 0) the link alternates up ~UP s /
                      down ~DOWN s; each phase length is drawn from the
                      seeded per-link stream in [0.5x, 1.5x) of nominal

Injection points (all gated on `NET_CHAOS is None` — one module-global load
per flush/dial when disabled, zero per-frame work):
  - protocol._Cork.flush: frames to a blackholed/flap-down peer are silently
    dropped (the connection stays open and HANGS — partitions don't error);
    delay/jitter defer the transport write, FIFO per connection
  - Connection._read_loop / Server._on_client: frames RECEIVED from a
    partitioned peer are dropped too, so one chaos-enabled process can
    simulate a symmetric partition against peers that never installed a spec
  - util.aio.dial: dialing a blackholed peer hangs until the dial timeout
    (SYN into the void), healing mid-wait if the schedule says so
  - protocol.fence_close: a transport close toward a blackholed peer is
    DEFERRED until the link heals — a real partition does not deliver FIN,
    so the far side must discover its death verdict at heal time, not get
    tipped off by an impossible EOF

Link identity: each process declares its own node (set_local_node) and
labels outgoing connections with the peer's node where it knows it (dials to
the head are "n0"; the head labels agent/worker dials and its server-side
registration writers; submitters label lease-grant worker connections from
the lease directory).  Unlabeled connections are never touched.
"""

from __future__ import annotations

import bisect
import random
import time
import weakref
from collections import deque
from typing import Dict, List, Optional, Tuple

# fast-path gate: None = chaos disabled, every hook bypasses in one check
NET_CHAOS: Optional["NetworkChaos"] = None

# this process's node id (link source for outgoing frames)
_local_node: str = "n0"

# known peer addresses -> node ids (fallback labeling for dials)
_addr_nodes: Dict[str, str] = {}

# outgoing writer -> peer node id (weak: dies with the transport)
_writer_links: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def set_local_node(node_id: str) -> None:
    global _local_node
    if node_id:
        _local_node = node_id


def local_node() -> str:
    return _local_node


_ADDR_NODES_CAP = 4096  # drop-oldest bound: worker churn must not leak


def register_addr(addr: Optional[str], node_id: Optional[str]) -> None:
    """Remember which node serves `addr` (labels future dials to it).
    Bounded drop-oldest: a long-lived process churning through short-lived
    worker addresses keeps at most the most recent _ADDR_NODES_CAP entries
    (an evicted live address just loses its chaos label, never breaks)."""
    if addr and node_id:
        _addr_nodes[addr] = node_id
        while len(_addr_nodes) > _ADDR_NODES_CAP:
            del _addr_nodes[next(iter(_addr_nodes))]


def node_for_addr(addr: Optional[str]) -> Optional[str]:
    return _addr_nodes.get(addr) if addr else None


def label_writer(writer, dst_node: Optional[str]) -> None:
    """Tag a transport with its peer's node id; chaos decisions for frames
    on this writer use the (local_node, dst_node) link policy."""
    if writer is not None and dst_node:
        _writer_links[writer] = dst_node


def link_of(writer) -> Optional[str]:
    try:
        return _writer_links.get(writer)
    except TypeError:
        return None


class LinkPolicy:
    __slots__ = (
        "src", "dst", "delay_s", "jitter_s", "bh_start", "bh_end",
        "flap_up", "flap_down", "flap_start",
    )

    def __init__(self, src: str, dst: str):
        self.src = src
        self.dst = dst
        self.delay_s = 0.0
        self.jitter_s = 0.0
        self.bh_start: Optional[float] = None  # None = no blackhole
        self.bh_end = float("inf")
        self.flap_up = 0.0  # 0 = no flap
        self.flap_down = 0.0
        self.flap_start = 0.0


def _parse_action(pol: LinkPolicy, act: str) -> None:
    act = act.strip()
    if not act:
        return
    if act == "blackhole":
        pol.bh_start, pol.bh_end = 0.0, float("inf")
    elif act.startswith("blackhole@"):
        start, _, dur = act[len("blackhole@"):].partition("+")
        pol.bh_start = float(start)
        pol.bh_end = pol.bh_start + float(dur) if dur else float("inf")
    elif act.startswith("delay="):
        pol.delay_s = float(act[len("delay="):])
    elif act.startswith("jitter="):
        pol.jitter_s = float(act[len("jitter="):])
    elif act.startswith("flap="):
        body = act[len("flap="):]
        body, _, start = body.partition("@")
        up, _, down = body.partition("/")
        pol.flap_up = float(up)
        pol.flap_down = float(down or up)
        pol.flap_start = float(start) if start else 0.0
        if pol.flap_up <= 0 or pol.flap_down <= 0:
            raise ValueError(f"flap phases must be positive: {act!r}")
    else:
        raise ValueError(
            f"unknown net-chaos action {act!r} (want blackhole[@S+D], "
            f"delay=SEC, jitter=SEC, flap=UP/DOWN[@S])"
        )


class NetworkChaos:
    """Parsed spec + seeded schedules + decision entry points.

    Deterministic by construction: flap phase lengths and per-frame jitter
    come from per-link `random.Random` streams seeded by (seed, src, dst),
    and every window is an offset from one shared epoch — two instances
    built from the same spec produce identical schedules and identical
    per-frame decision sequences (asserted in tests/test_partition.py).
    """

    def __init__(self, spec: str, local: Optional[str] = None, now: Optional[float] = None):
        self.spec = spec
        self.seed = 0
        self.epoch = now if now is not None else time.time()
        self.local = local or _local_node
        self.policies: Dict[Tuple[str, str], LinkPolicy] = {}
        self.stats: Dict[str, int] = {
            "frames_dropped": 0,
            "frames_delayed": 0,
            "recv_dropped": 0,
            "dials_blocked": 0,
            "closes_deferred": 0,
        }
        self.events: deque = deque(maxlen=4096)
        links: List[Tuple[str, str, str]] = []
        for clause in filter(None, (c.strip() for c in (spec or "").split(";"))):
            if clause.startswith("seed="):
                self.seed = int(clause[len("seed="):])
            elif clause.startswith("epoch="):
                self.epoch = float(clause[len("epoch="):])
            else:
                link, sep, actions = clause.partition(":")
                if not sep:
                    raise ValueError(f"bad net-chaos clause {clause!r}")
                if "<>" in link:
                    a, b = link.split("<>", 1)
                    links.append((a.strip(), b.strip(), actions))
                    links.append((b.strip(), a.strip(), actions))
                elif ">" in link:
                    a, b = link.split(">", 1)
                    links.append((a.strip(), b.strip(), actions))
                else:
                    raise ValueError(
                        f"bad net-chaos link {link!r} (want SRC>DST or SRC<>DST)"
                    )
        for src, dst, actions in links:
            pol = self.policies.setdefault((src, dst), LinkPolicy(src, dst))
            for act in actions.split(","):
                _parse_action(pol, act)
        # seeded per-link streams: flap timelines are extended lazily but
        # deterministically; frame jitter draws consume the frame stream
        self._flap_toggles: Dict[Tuple[str, str], List[float]] = {}
        self._frame_rngs: Dict[Tuple[str, str], random.Random] = {}
        # last observed up/down state per link, so transitions land in the
        # event log exactly once (observation timing doesn't change the
        # SCHEDULE, which is what determinism tests assert)
        self._last_state: Dict[Tuple[str, str], bool] = {}

    # ------------------------------------------------------------- schedule
    def _link_rng(self, key: Tuple[str, str], stream: str) -> random.Random:
        return random.Random(f"{self.seed}:{stream}:{key[0]}>{key[1]}")

    def _toggles(self, key: Tuple[str, str], until: float) -> List[float]:
        """Flap toggle offsets [down0, up0, down1, up1, ...] extended (from
        the seeded stream, so extension is deterministic) to cover `until`."""
        pol = self.policies[key]
        tl = self._flap_toggles.get(key)
        if tl is None:
            tl = self._flap_toggles[key] = [pol.flap_start]
        # phase lengths depend only on their index, never on how far a
        # previous call extended the list — interleaved queries on the same
        # link therefore cannot perturb the schedule
        while tl[-1] <= until:
            i = len(tl)
            rng = self._link_rng(key, f"flapn:{i}")
            nominal = pol.flap_down if i % 2 == 1 else pol.flap_up
            tl.append(tl[-1] + nominal * (0.5 + rng.random()))
        return tl

    def flap_schedule(self, src: str, dst: str, horizon_s: float) -> List[Tuple[str, float]]:
        """The link's up/down transition schedule out to `horizon_s`
        (offsets from epoch) — pure function of (spec, seed)."""
        key = (src, dst)
        pol = self.policies.get(key)
        if pol is None or not pol.flap_up:
            return []
        tl = self._toggles(key, horizon_s)
        out = []
        for i, t in enumerate(tl):
            if t > horizon_s:
                break
            out.append(("down" if i % 2 == 0 else "up", round(t, 6)))
        return out

    # ------------------------------------------------------------ decisions
    def t_rel(self, now: Optional[float] = None) -> float:
        return (time.time() if now is None else now) - self.epoch

    def link_down(self, src: Optional[str], dst: Optional[str], now: Optional[float] = None) -> bool:
        if src is None or dst is None:
            return False
        key = (src, dst)
        pol = self.policies.get(key)
        if pol is None:
            return False
        t = self.t_rel(now)
        down = False
        if pol.bh_start is not None and pol.bh_start <= t < pol.bh_end:
            down = True
        elif pol.flap_up and t >= pol.flap_start:
            tl = self._toggles(key, t)
            # odd toggle count passed -> inside a DOWN phase (the schedule
            # starts with a down phase at flap_start)
            down = bisect.bisect_right(tl, t) % 2 == 1
        prev = self._last_state.get(key)
        if prev != down:
            self._last_state[key] = down
            self.events.append(
                ("down" if down else "up", src, dst, round(t, 3))
            )
            # flight recorder: the schedule firing, with the seed so a chaos
            # incident timeline can be replayed from the journal alone
            from ..util import flightrec

            if flightrec.REC is not None:
                flightrec.REC.record(
                    "chaos", "link_down" if down else "link_up",
                    src=src, dst=dst, t_rel=round(t, 3),
                    seed=self.seed, spec=self.spec,
                )
        return down

    def frame_delay(self, src: Optional[str], dst: Optional[str]) -> float:
        if src is None or dst is None:
            return 0.0
        pol = self.policies.get((src, dst))
        if pol is None:
            return 0.0
        d = pol.delay_s
        if pol.jitter_s:
            rng = self._frame_rngs.get((src, dst))
            if rng is None:
                rng = self._frame_rngs[(src, dst)] = self._link_rng(
                    (src, dst), "frames"
                )
            d += rng.random() * pol.jitter_s
        return d

    def count(self, stat: str, n: int = 1) -> None:
        self.stats[stat] = self.stats.get(stat, 0) + n


# ---------------------------------------------------------------- lifecycle
def install(spec: str, local_node_id: Optional[str] = None,
            epoch: Optional[float] = None) -> Optional[NetworkChaos]:
    """Parse and activate a spec in THIS process (empty spec deactivates).
    Raises ValueError on a malformed spec — a typo'd chaos schedule that
    silently injects nothing would invalidate the test relying on it."""
    global NET_CHAOS
    if local_node_id:
        set_local_node(local_node_id)
    if not (spec or "").strip():
        NET_CHAOS = None
        return None
    NET_CHAOS = NetworkChaos(spec, local=_local_node, now=epoch)
    return NET_CHAOS


def clear() -> None:
    global NET_CHAOS
    NET_CHAOS = None


def maybe_install_from_config(config, local_node_id: Optional[str] = None) -> None:
    """Process-start installation from config.testing_net_chaos (the
    CA_TESTING_NET_CHAOS env override rides the same field)."""
    if local_node_id:
        set_local_node(local_node_id)
    spec = getattr(config, "testing_net_chaos", "") or ""
    if spec.strip():
        install(spec, local_node_id)


def status() -> dict:
    ch = NET_CHAOS
    if ch is None:
        return {"active": False}
    return {
        "active": True,
        "spec": ch.spec,
        "seed": ch.seed,
        "epoch": ch.epoch,
        "local": ch.local,
        "links": [f"{s}>{d}" for (s, d) in ch.policies],
        "stats": dict(ch.stats),
        "events": list(ch.events)[-50:],
    }
