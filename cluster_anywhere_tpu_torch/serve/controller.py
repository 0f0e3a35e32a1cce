"""ServeController: the reconciliation control loop (analogue of
python/ray/serve/_private/controller.py ServeController +
deployment_state.py DeploymentStateManager).

A detached named actor. Holds desired state (applications -> deployments ->
target replica counts), reconciles actual replica actors toward it on a
background thread, runs autoscaling from replica queue-length metrics,
replaces dead replicas, and bumps a version counter per deployment that
routers poll (the long-poll analogue of serve/_private/long_poll.py).

Threading: all methods are sync and run on the actor's executor pool
(max_concurrency > 1); the reconcile loop is a dedicated thread. Blocking
`ca.get` is safe on these threads (the process's IO loop is separate); it
would deadlock on the loop itself, so nothing here is async.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Dict, List

from ..core import api as ca
from ..core.actor import get_actor, kill
from ..util import flightrec
from .config import DeploymentConfig, DeploymentStatus
from .replica import Replica

CONTROLLER_NAME = "SERVE_CONTROLLER"


class _DeploymentState:
    def __init__(self, app: str, name: str, payload: bytes, cfg: DeploymentConfig):
        self.app = app
        self.name = name
        # the pickled (deployment_def, init_args, init_kwargs): only the
        # replicas unpickle it, so the controller never imports the user's
        # code (an LLM deployment's would cost it a torch import)
        self.payload = payload
        self.cfg = cfg
        self.target = (
            cfg.autoscaling_config.min_replicas
            if cfg.autoscaling_config
            else cfg.num_replicas
        )
        self.replicas: Dict[str, Any] = {}  # replica_id -> actor handle
        self.version = 0
        self.replica_counter = 0
        self.status = "UPDATING"
        self.message = ""
        self.payload_digest: str = ""
        # generation disambiguates replica actor names across redeploys;
        # retired tells a mid-flight reconcile pass to stop touching this state
        self.generation = 0
        self.retired = False
        self._last_scale_t = 0.0
        # drain plane: replicas on announced-exiting nodes.  STICKY — once a
        # replica is draining it only leaves the set by being retired/dying,
        # never by the drain window expiring (a node past its deadline is
        # about to be killed, not coming back).  Routers stop picking these;
        # the reconcile pass starts replacements first and retires each
        # draining replica once it has zero in-flight requests.
        self.draining_rids: set = set()
        self.draining_marked: Dict[str, float] = {}  # rid -> monotonic mark time
        self.replica_nodes: Dict[str, str] = {}  # replica_id -> node_id
        self.qlens: Dict[str, int] = {}  # replica_id -> last reported ongoing
        # autoscale observability: the last actual scale decision and the
        # last observation that informed one (ca status / /api/serve)
        self.last_scale: Optional[Dict[str, Any]] = None
        self.last_autoscale_obs: Optional[Dict[str, Any]] = None

    def key(self) -> str:
        return f"{self.app}/{self.name}"

    def active_rids(self) -> List[str]:
        return [rid for rid in self.replicas if rid not in self.draining_rids]


class ServeController:
    def __init__(self):
        self.apps: Dict[str, Dict[str, _DeploymentState]] = {}
        self.route_prefixes: Dict[str, str] = {}  # app -> route_prefix
        self.ingress: Dict[str, str] = {}  # app -> ingress deployment name
        self._lock = threading.RLock()
        self._stopped = False
        self._last_plane_pub = 0.0
        self._thread = threading.Thread(
            target=self._reconcile_loop, daemon=True, name="serve-reconcile"
        )
        self._thread.start()

    # ------------------------------------------------------------ deploy API
    def deploy_application(
        self,
        app_name: str,
        route_prefix: str,
        ingress: str,
        deployments: List[Dict[str, Any]],
    ) -> str:
        import pickle

        with self._lock:
            app = self.apps.setdefault(app_name, {})
            wanted = set()
            for spec in deployments:
                name = spec["name"]
                wanted.add(name)
                cfg: DeploymentConfig = pickle.loads(spec["config"])
                old = app.get(name)
                st = _DeploymentState(app_name, name, spec["payload"], cfg)
                st.payload_digest = __import__("hashlib").sha256(spec["payload"]).hexdigest()
                if old is not None:
                    old.retired = True  # a mid-flight reconcile must stop
                    st.replica_counter = old.replica_counter
                    st.generation = old.generation + 1
                    st.version = old.version + 1
                    if st.payload_digest == getattr(old, "payload_digest", None):
                        # same code: keep live replicas, push config deltas
                        st.replicas = old.replicas
                        st.generation = old.generation
                        st.draining_rids = old.draining_rids
                        st.draining_marked = old.draining_marked
                        st.replica_nodes = old.replica_nodes
                        st.qlens = old.qlens
                        if cfg.user_config is not None and old.cfg.user_config != cfg.user_config:
                            for h in st.replicas.values():
                                try:
                                    h.reconfigure.remote(cfg.user_config)
                                except Exception:
                                    pass
                    else:
                        # code/init-args changed: old replicas must not keep
                        # serving stale code — replace them
                        self._teardown_deployment(old)
                app[name] = st
            for name in list(app):
                if name not in wanted:
                    app[name].retired = True
                    self._teardown_deployment(app[name])
                    del app[name]
            self.route_prefixes[app_name] = route_prefix
            self.ingress[app_name] = ingress
        return "ok"

    def wait_ready(self, app_name: str, timeout_s: float = 60.0) -> str:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                app = dict(self.apps.get(app_name, {}))
                statuses = {n: (st.status, st.message) for n, st in app.items()}
            if statuses and all(s == "HEALTHY" for s, _ in statuses.values()):
                return "ok"
            for n, (s, msg) in statuses.items():
                if s == "UNHEALTHY":
                    raise RuntimeError(f"deployment {app_name}/{n} unhealthy: {msg}")
            time.sleep(0.05)
        raise TimeoutError(f"app {app_name!r} not ready after {timeout_s}s")

    def delete_application(self, app_name: str) -> str:
        with self._lock:
            app = self.apps.pop(app_name, None)
            self.route_prefixes.pop(app_name, None)
            self.ingress.pop(app_name, None)
            if app:
                for st in app.values():
                    st.retired = True
        if app:
            for st in app.values():
                self._teardown_deployment(st)
        return "ok"

    def shutdown(self) -> str:
        with self._lock:
            apps, self.apps = self.apps, {}
            self._stopped = True
        for app in apps.values():
            for st in app.values():
                self._teardown_deployment(st)
        return "ok"

    def _teardown_deployment(self, st: _DeploymentState):
        for h in st.replicas.values():
            try:
                kill(h)
            except Exception:
                pass
        st.replicas.clear()
        st.draining_rids.clear()
        st.draining_marked.clear()
        st.qlens.clear()
        st.replica_nodes.clear()

    # ----------------------------------------------------------- router API
    def get_deployment_info(self, app: str, deployment: str) -> Dict[str, Any]:
        with self._lock:
            st = self._state(app, deployment)
            return {
                "version": st.version,
                "max_ongoing_requests": st.cfg.max_ongoing_requests,
                "replicas": [
                    {
                        "replica_id": rid,
                        "actor_name": self._replica_actor_name(st, rid),
                        # routers stop picking draining replicas (in-flight
                        # streams on them run to completion)
                        "draining": rid in st.draining_rids,
                        # last controller-observed ongoing count: the shared
                        # load signal behind power-of-two-choices (each
                        # router's local view only sees its own traffic)
                        "queue_len": int(st.qlens.get(rid, 0)),
                    }
                    for rid in st.replicas
                ],
            }

    def poll_deployment_info(
        self, app: str, deployment: str, known_version: int, timeout_s: float = 10.0
    ) -> Dict[str, Any]:
        """Long-poll: returns when version != known_version or timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                st = self._state(app, deployment)
                if st.version != known_version:
                    break
            time.sleep(0.05)
        return self.get_deployment_info(app, deployment)

    def get_app_route(self, app: str) -> Dict[str, str]:
        with self._lock:
            return {
                "route_prefix": self.route_prefixes.get(app, "/"),
                "ingress": self.ingress.get(app, ""),
            }

    def list_routes(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            out: Dict[str, Dict[str, Any]] = {}
            for app, ing in self.ingress.items():
                info: Dict[str, Any] = {
                    "route_prefix": self.route_prefixes.get(app, "/"),
                    "ingress": ing,
                }
                st = self.apps.get(app, {}).get(ing)
                if st is not None:
                    # the proxy's admission gate rides the route table: the
                    # policy plus the live capacity its depth cap derives from
                    info["max_ongoing_requests"] = st.cfg.max_ongoing_requests
                    info["replicas"] = len(st.active_rids()) or len(st.replicas)
                    if st.cfg.admission is not None:
                        info["admission"] = st.cfg.admission.to_wire()
                out[app] = info
            return out

    def status(self) -> Dict[str, Any]:
        with self._lock:
            out: Dict[str, Any] = {}
            for app_name, app in self.apps.items():
                out[app_name] = {}
                for name, st in app.items():
                    n_drain = len(st.draining_rids & set(st.replicas))
                    states = {"RUNNING": len(st.replicas) - n_drain}
                    if n_drain:
                        states["DRAINING"] = n_drain
                    out[app_name][name] = DeploymentStatus(
                        name=name,
                        status=st.status,
                        replica_states=states,
                        message=st.message,
                    ).__dict__
            return out

    def serve_plane_info(self) -> Dict[str, Any]:
        """Autoscale + drain observability: per-deployment target vs actual
        replicas, per-replica node/queue/draining state, and the last scale
        decision — the payload behind `ca status`, /api/serve, and
        util.state.serve_plane()."""
        with self._lock:
            out: Dict[str, Any] = {}
            for app_name, app in self.apps.items():
                out[app_name] = {}
                for name, st in app.items():
                    out[app_name][name] = {
                        "status": st.status,
                        "version": st.version,
                        "target_replicas": st.target,
                        "actual_replicas": len(st.replicas),
                        "draining_replicas": sorted(
                            st.draining_rids & set(st.replicas)
                        ),
                        "max_ongoing_requests": st.cfg.max_ongoing_requests,
                        "autoscaling": st.cfg.autoscaling_config is not None,
                        "admission": (
                            st.cfg.admission.to_wire()
                            if st.cfg.admission is not None else None
                        ),
                        "replicas": {
                            rid: {
                                "node_id": st.replica_nodes.get(rid),
                                "queue_len": int(st.qlens.get(rid, 0)),
                                "draining": rid in st.draining_rids,
                            }
                            for rid in st.replicas
                        },
                        "last_scale": st.last_scale,
                        "last_autoscale_obs": st.last_autoscale_obs,
                    }
            return out

    def ping(self) -> str:
        return "pong"

    def _state(self, app: str, deployment: str) -> _DeploymentState:
        try:
            return self.apps[app][deployment]
        except KeyError:
            raise KeyError(f"unknown deployment {app}/{deployment}")

    # ------------------------------------------------------------- reconcile
    def _replica_actor_name(self, st: _DeploymentState, rid: str) -> str:
        # generation-qualified: replicas of a retired deploy can never collide
        # with the names the replacement state will use
        return f"SERVE_REPLICA::{st.app}::{st.name}::g{st.generation}::{rid}"

    def _draining_node_ids(self) -> set:
        """Nodes inside an announced drain window.  The head pushes `drain`
        pubs to every client — including this controller's host process — so
        the read is a local dict lookup, zero RPCs."""
        try:
            from ..core.worker import global_worker

            return global_worker().draining_node_ids()
        except Exception:
            return set()

    def _publish_plane_digest(self):
        """Ship serve_plane_info to the head KV (~1/s): `ca status`, the
        dashboard's /api/serve, and util.state.serve_plane() read it without
        needing an actor round-trip to this controller."""
        import json as _json

        now = time.monotonic()
        if now - self._last_plane_pub < 1.0:
            return
        self._last_plane_pub = now
        try:
            from ..core.worker import global_worker

            global_worker().head_call(
                "kv_put", key="serve:plane",
                value=_json.dumps(self.serve_plane_info(), default=str).encode(),
            )
        except Exception:
            pass  # head briefly unreachable: next tick retries

    def _reconcile_loop(self):
        while not self._stopped:
            try:
                with self._lock:
                    states = [
                        st for app in self.apps.values() for st in app.values()
                    ]
                draining_nodes = self._draining_node_ids()
                for st in states:
                    self._mark_draining(st, draining_nodes)
                    self._reconcile_deployment(st)
                    self._autoscale(st)
                self._publish_plane_digest()
            except Exception:
                traceback.print_exc()
            time.sleep(0.1)

    def _mark_draining(self, st: _DeploymentState, draining_nodes: set):
        """Flag replicas hosted on announced-exiting nodes (sticky).  The
        version bump makes every router refresh and stop picking them —
        step one of the zero-drop drain story."""
        if not draining_nodes or st.retired:
            return
        newly = {
            rid
            for rid, nid in st.replica_nodes.items()
            if nid in draining_nodes and rid in st.replicas
        } - st.draining_rids
        if newly:
            now = time.monotonic()
            with self._lock:
                st.draining_rids |= newly
                for rid in newly:
                    st.draining_marked[rid] = now
            self._bump_version(st)
            if flightrec.REC is not None:
                flightrec.REC.record(
                    "serve", "serve_replica_draining", deployment=st.key(),
                    replicas=sorted(newly),
                    nodes=sorted({st.replica_nodes.get(r) for r in newly
                                  if st.replica_nodes.get(r)}),
                )

    def _bump_version(self, st: _DeploymentState):
        with self._lock:
            st.version += 1

    def _retire_replica(self, st: _DeploymentState, rid: str, h) -> None:
        try:
            ca.get(h.prepare_shutdown.remote(), timeout=st.cfg.graceful_shutdown_timeout_s)
        except Exception:
            pass
        try:
            kill(h)
        except Exception:
            pass

    def _reconcile_deployment(self, st: _DeploymentState):
        if st.retired:
            return
        # telemetry doubles as the health check: one RPC per replica per
        # pass yields alive/deadness, the ongoing-request count (router P2C
        # signal + drain retirement gate + autoscale input), and the hosting
        # node (drain detection)
        dead = []
        for rid, h in list(st.replicas.items()):
            try:
                t = ca.get(h.telemetry.remote(), timeout=30)
                with self._lock:
                    st.qlens[rid] = int(t.get("queue_len", 0))
                    if t.get("node_id"):
                        st.replica_nodes[rid] = t["node_id"]
            except Exception:
                dead.append(rid)
        for rid in dead:
            try:
                kill(st.replicas[rid])
            except Exception:
                pass
            with self._lock:
                st.replicas.pop(rid, None)
                st.draining_rids.discard(rid)
                st.draining_marked.pop(rid, None)
                st.qlens.pop(rid, None)
                st.replica_nodes.pop(rid, None)
        if dead:
            self._bump_version(st)
            if flightrec.REC is not None:
                flightrec.REC.record(
                    "serve", "serve_replica_dead", deployment=st.key(),
                    replicas=dead,
                )
        changed = False
        # replacements FIRST: spawn until the ACTIVE (non-draining) count
        # reaches target.  Draining replicas keep serving their in-flight
        # requests but no longer count toward capacity; new actors place on
        # survivors automatically (the head excludes draining nodes).
        while len(st.active_rids()) < st.target and not self._stopped and not st.retired:
            with self._lock:
                rid = f"r{st.replica_counter}"
                st.replica_counter += 1
            Rep = ca.remote(Replica).options(
                name=self._replica_actor_name(st, rid),
                max_restarts=st.cfg.max_restarts,
                **st.cfg.actor_options(),
            )
            try:
                h = Rep.remote(
                    st.payload,
                    st.cfg.user_config,
                    rid,
                    deployment_name=f"{st.app}:{st.name}",
                )
                t = ca.get(h.telemetry.remote(), timeout=60)
            except Exception as e:
                st.status = "UNHEALTHY"
                st.message = f"replica start failed: {e!r}"
                return
            if st.retired:
                # deploy/delete raced with this spawn: don't leak the replica
                try:
                    kill(h)
                except Exception:
                    pass
                return
            with self._lock:
                st.replicas[rid] = h
                st.qlens[rid] = 0
                if t.get("node_id"):
                    st.replica_nodes[rid] = t["node_id"]
            changed = True
            if flightrec.REC is not None:
                # replacement or migration target: pairs with the draining /
                # dead event that caused it in the incident timeline
                flightrec.REC.record(
                    "serve", "serve_replica_started", deployment=st.key(),
                    replica=rid, node=t.get("node_id"),
                )
        # normal downscale: retire surplus ACTIVE replicas (draining ones
        # are on their own retirement track below)
        while len(st.active_rids()) > st.target:
            with self._lock:
                rid = st.active_rids()[0]
                h = st.replicas.pop(rid)
                st.qlens.pop(rid, None)
                st.replica_nodes.pop(rid, None)
            self._retire_replica(st, rid, h)
            changed = True
            if flightrec.REC is not None:
                flightrec.REC.record(
                    "serve", "serve_replica_retired", deployment=st.key(),
                    replica=rid, reason="downscale",
                )
        # drain retirement: once replacements are up, retire each draining
        # replica when its last in-flight request (including SSE streams)
        # finishes.  The grace window matters: routers only refresh on-route
        # (~1s period), so a replica marked draining can still RECEIVE a
        # request for up to a refresh period — killing it at the first
        # qlen==0 sample would race that request.  2.5s > 2x refresh closes
        # the window; after it, every router has seen the draining flag.
        if st.draining_rids:
            now = time.monotonic()
            for rid in sorted(st.draining_rids & set(st.replicas)):
                if len(st.active_rids()) < st.target:
                    break  # replacements not ready: keep serving
                if now - st.draining_marked.get(rid, 0.0) < 2.5:
                    continue  # routers may still route here: too early
                if st.qlens.get(rid, 1) != 0:
                    continue  # in-flight work: let it run out
                with self._lock:
                    h = st.replicas.pop(rid)
                    st.draining_rids.discard(rid)
                    st.draining_marked.pop(rid, None)
                    st.qlens.pop(rid, None)
                    st.replica_nodes.pop(rid, None)
                self._retire_replica(st, rid, h)
                changed = True
                if flightrec.REC is not None:
                    # zero-drop migration complete: last in-flight request
                    # finished, replacements carried the traffic
                    flightrec.REC.record(
                        "serve", "serve_replica_retired", deployment=st.key(),
                        replica=rid, reason="drained",
                    )
        if changed:
            self._bump_version(st)
        st.status = (
            "HEALTHY" if len(st.active_rids()) == st.target else "UPDATING"
        )
        if st.status == "HEALTHY":
            st.message = ""

    def _autoscale(self, st: _DeploymentState):
        cfg = st.cfg.autoscaling_config
        if cfg is None or not st.replicas or st.retired:
            return
        # draining replicas are excluded: their load is migrating to the
        # actives, and counting them would double the apparent demand right
        # when capacity planning matters most
        lens = [
            st.qlens[rid] for rid in st.active_rids() if rid in st.qlens
        ]
        if not lens:
            return
        avg = sum(lens) / len(lens)
        desired = max(
            cfg.min_replicas,
            min(
                cfg.max_replicas,
                -(-int(len(lens) * avg) // max(int(cfg.target_ongoing_requests), 1))
                if avg > 0
                else cfg.min_replicas,
            ),
        )
        now = time.monotonic()
        st.last_autoscale_obs = {
            "ts": time.time(),
            "avg_ongoing": round(avg, 3),
            "active_replicas": len(lens),
            "desired": desired,
        }
        decided = None
        if desired > st.target and now - st._last_scale_t > cfg.upscale_delay_s:
            decided = ("up", st.target, desired)
            st.target = desired
            st._last_scale_t = now
        elif desired < st.target and now - st._last_scale_t > cfg.downscale_delay_s:
            decided = ("down", st.target, max(desired, cfg.min_replicas))
            st.target = max(desired, cfg.min_replicas)
            st._last_scale_t = now
        if decided is not None:
            st.last_scale = {
                "ts": time.time(),
                "direction": decided[0],
                "from": decided[1],
                "to": decided[2],
                "avg_ongoing": round(avg, 3),
            }
            if flightrec.REC is not None:
                flightrec.REC.record(
                    "serve", "serve_autoscale", deployment=st.key(),
                    direction=decided[0], from_replicas=decided[1],
                    to_replicas=decided[2], avg_ongoing=round(avg, 3),
                )


def get_or_create_controller():
    """Get the cluster's controller actor, creating it if needed."""
    from ..core.scheduling_strategies import NodeAffinitySchedulingStrategy

    try:
        return get_actor(CONTROLLER_NAME)
    except Exception:
        pass
    Controller = ca.remote(ServeController).options(
        name=CONTROLLER_NAME, lifetime="detached", num_cpus=0.1, max_concurrency=16,
        # system actors live with the control plane: the head node never
        # drains, so the controller doesn't restart mid-drain-orchestration
        # (soft: single-node clusters and full heads still place somewhere)
        scheduling_strategy=NodeAffinitySchedulingStrategy("n0", soft=True),
    )
    try:
        h = Controller.remote()
        ca.get(h.ping.remote(), timeout=30)
        return h
    except Exception:
        # lost the creation race: someone else made it
        return get_actor(CONTROLLER_NAME)
