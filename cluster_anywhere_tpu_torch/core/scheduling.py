"""Node scheduling policies (analogue of src/ray/raylet/scheduling/policy/*).

Pure functions over node views so they are unit-testable without a head:
the head passes a list of (node_id, total, avail) snapshots and gets back a
node choice (or a full bundle->node assignment for placement groups).

Policies mirrored from the reference:
- hybrid (hybrid_scheduling_policy.h): pack onto already-used nodes while
  their critical-resource utilization stays below a threshold (default 0.5),
  then spread by least utilization.
- spread (spread_scheduling_policy.h): least-utilized first.
- node affinity (node_affinity_scheduling_policy.h): a specific node, with a
  soft fallback to hybrid.
- node labels (node_label_scheduling_policy.h): hard/soft key->condition
  selectors over the labels each node registered with (CA_NODE_LABELS and
  ca.io/node-id).
- bundle placement (bundle_scheduling_policy.h): PACK / SPREAD /
  STRICT_PACK / STRICT_SPREAD over placement-group bundles, each bundle
  optionally constrained to label-matching nodes.
"""

from __future__ import annotations

from typing import Container, Dict, List, Optional, Sequence, Tuple

Shape = Dict[str, float]


def fits(avail: Shape, shape: Shape) -> bool:
    return all(avail.get(k, 0.0) + 1e-9 >= v for k, v in shape.items())


def take(avail: Shape, shape: Shape) -> None:
    for k, v in shape.items():
        avail[k] = avail.get(k, 0.0) - v


def utilization(total: Shape, avail: Shape) -> float:
    """Critical-resource utilization: max over resources of used/total."""
    worst = 0.0
    for k, t in total.items():
        if t > 0:
            u = (t - avail.get(k, 0.0)) / t
            if u > worst:
                worst = u
    return worst


class NodeView:
    """Mutable scheduling snapshot of one node (the policy `take`s from it
    while simulating multi-item placement)."""

    __slots__ = ("node_id", "total", "avail", "index", "labels")

    def __init__(
        self,
        node_id: str,
        total: Shape,
        avail: Shape,
        index: int = 0,
        labels: Optional[Dict[str, str]] = None,
    ):
        self.node_id = node_id
        self.total = dict(total)
        self.avail = dict(avail)
        self.index = index  # join order; lower = longer-lived (head node first)
        self.labels = labels or {}


def rank_hybrid(nodes: Sequence, threshold: float) -> List:
    """Hybrid order: nodes under the utilization threshold first (in join
    order — pack onto the earliest nodes), then the rest by least utilized.
    Accepts any node-like object with .total/.avail/.index (NodeView
    snapshots or the head's live NodeRecs)."""
    below, above = [], []
    for n in nodes:
        (below if utilization(n.total, n.avail) <= threshold else above).append(n)
    below.sort(key=lambda n: n.index)
    above.sort(key=lambda n: utilization(n.total, n.avail))
    return below + above


def rank_spread(nodes: Sequence) -> List:
    return sorted(nodes, key=lambda n: (utilization(n.total, n.avail), n.index))


def match_labels(labels: Dict[str, str], selector: Optional[Dict[str, dict]]) -> bool:
    """Does a node's label map satisfy a selector?  Selector values are wire
    dicts: {"op": "in"|"!in"|"exists"|"!exists", "values": [...]}
    (label_selector semantics of node_label_scheduling_policy.h)."""
    if not selector:
        return True
    for key, cond in selector.items():
        op = cond.get("op", "in")
        present = key in labels
        if op == "exists":
            if not present:
                return False
        elif op == "!exists":
            if present:
                return False
        elif op == "in":
            if not present or labels[key] not in cond.get("values", ()):
                return False
        elif op == "!in":
            if present and labels[key] in cond.get("values", ()):
                return False
        else:
            raise ValueError(f"unknown label-selector op {op!r}")
    return True


def filter_rank_labels(nodes: Sequence, strategy: dict, threshold: float) -> List:
    """NODE_LABEL ranking: drop nodes failing the hard selector, then order
    soft-selector matches first; hybrid rank within each tier (so labels pick
    the candidate set and the usual utilization policy picks within it)."""
    hard = strategy.get("hard")
    soft = strategy.get("soft")
    cands = [n for n in nodes if match_labels(getattr(n, "labels", None) or {}, hard)]
    if not soft:
        return rank_hybrid(cands, threshold)
    pref = [n for n in cands if match_labels(getattr(n, "labels", None) or {}, soft)]
    pref_ids = {id(n) for n in pref}
    rest = [n for n in cands if id(n) not in pref_ids]
    return rank_hybrid(pref, threshold) + rank_hybrid(rest, threshold)


def pick_node(
    nodes: Sequence[NodeView],
    shape: Shape,
    strategy: Optional[dict] = None,
    threshold: float = 0.5,
) -> Optional[NodeView]:
    """Choose a node for one resource shape. `strategy` is a wire dict:
    None/{"type":"DEFAULT"} = hybrid; {"type":"SPREAD"};
    {"type":"NODE_AFFINITY","node_id":...,"soft":bool};
    {"type":"NODE_LABEL","hard":selector,"soft":selector}."""
    kind = (strategy or {}).get("type", "DEFAULT")
    if kind == "NODE_AFFINITY":
        want = strategy.get("node_id")
        for n in nodes:
            if n.node_id == want:
                if fits(n.avail, shape):
                    return n
                break
        if not strategy.get("soft", False):
            return None
        kind = "DEFAULT"
    if kind == "NODE_LABEL":
        ranked = filter_rank_labels(nodes, strategy, threshold)
    elif kind == "SPREAD":
        ranked = rank_spread(nodes)
    else:
        ranked = rank_hybrid(nodes, threshold)
    for n in ranked:
        if fits(n.avail, shape):
            return n
    return None


def place_bundles(
    nodes: Sequence[NodeView],
    bundles: Sequence[Shape],
    strategy: str,
    threshold: float = 0.5,
    bundle_labels: Optional[Sequence[Optional[Dict[str, dict]]]] = None,
) -> Optional[List[str]]:
    """Assign each bundle a node id per the PG strategy, simulating resource
    consumption as it goes.  Returns the node id per bundle, or None if the
    assignment is not currently possible (caller decides pending/infeasible).
    Mutates the passed NodeViews' avail (callers pass snapshots).
    `bundle_labels` optionally gives a hard label selector per bundle; a
    bundle only lands on nodes matching its selector."""

    def ok(n: NodeView, i: int) -> bool:
        if bundle_labels is None or bundle_labels[i] is None:
            return True
        return match_labels(n.labels, bundle_labels[i])

    out: List[Optional[str]] = [None] * len(bundles)
    if strategy == "STRICT_PACK":
        for n in rank_hybrid(nodes, threshold):
            if not all(ok(n, i) for i in range(len(bundles))):
                continue
            sim = dict(n.avail)
            if all(_sim_take(sim, b) for b in bundles):
                for i, b in enumerate(bundles):
                    take(n.avail, b)
                    out[i] = n.node_id
                return out  # all on one node
        return None
    if strategy == "STRICT_SPREAD":
        used: set = set()
        for i, b in enumerate(bundles):
            chosen = None
            for n in rank_spread(nodes):
                if n.node_id in used or not ok(n, i) or not fits(n.avail, b):
                    continue
                chosen = n
                break
            if chosen is None:
                return None
            take(chosen.avail, b)
            used.add(chosen.node_id)
            out[i] = chosen.node_id
        return out
    if strategy == "SPREAD":
        # round-robin over least-utilized nodes, wrapping when there are more
        # bundles than nodes (soft spread)
        for i, b in enumerate(bundles):
            chosen = None
            ranked = [n for n in rank_spread(nodes) if ok(n, i)]
            # prefer a node not used yet by this PG
            used_ids = set(x for x in out if x is not None)
            for n in ranked:
                if n.node_id not in used_ids and fits(n.avail, b):
                    chosen = n
                    break
            if chosen is None:
                for n in ranked:
                    if fits(n.avail, b):
                        chosen = n
                        break
            if chosen is None:
                return None
            take(chosen.avail, b)
            out[i] = chosen.node_id
        return out
    # PACK (default): fill the hybrid-ranked nodes with as few nodes as we can
    for i, b in enumerate(bundles):
        chosen = None
        for n in rank_hybrid(nodes, threshold):
            if ok(n, i) and fits(n.avail, b):
                chosen = n
                break
        if chosen is None:
            return None
        take(chosen.avail, b)
        out[i] = chosen.node_id
    return out


def _sim_take(avail: Shape, shape: Shape) -> bool:
    if not fits(avail, shape):
        return False
    take(avail, shape)
    return True


def rank_delegation(
    entries: Sequence[dict], pool: str, exclude: Optional[Container[str]] = None
) -> List[dict]:
    """Order lease-directory entries for a submitter's node choice on the
    lease plane (the client-side mirror of spread scheduling: the head picks
    WHERE capacity is delegated; the submitter only picks among blocks the
    head already sized).  Most free delegated slots first, so concurrent
    submitters fan out instead of stampeding one agent; entries without the
    pool are dropped, as are nodes in `exclude` (draining nodes — their
    blocks are being recalled, and a grant there would be killed at the
    drain deadline).  Occupancy is heartbeat-stale, so callers must treat
    the order as a hint and probe down the list on denial."""
    def free(e: dict) -> int:
        b = (e.get("pools") or {}).get(pool) or {}
        return int(b.get("size", 0)) - int(b.get("used", 0))

    ranked = [
        e
        for e in entries
        if (e.get("pools") or {}).get(pool)
        and not (exclude and e.get("node_id") in exclude)
    ]
    ranked.sort(key=lambda e: (-free(e), e.get("node_id", "")))
    return ranked
