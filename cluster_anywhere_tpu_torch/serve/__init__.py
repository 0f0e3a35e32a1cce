"""cluster_anywhere_tpu_torch.serve: scalable model serving on the actor
runtime (analogue of the reference's Ray Serve, python/ray/serve/).

    from cluster_anywhere_tpu_torch import serve

    @serve.deployment(num_replicas=2)
    class Model:
        def __call__(self, x):
            return x * 2

    handle = serve.run(Model.bind())
    assert handle.remote(21).result() == 42
"""

from __future__ import annotations

import inspect
import pickle
from typing import Any, Callable, Dict, List, Optional, Union

from ..core import api as ca
from ..core.actor import get_actor, kill
from .batching import batch
from .config import AdmissionPolicy, AutoscalingConfig, DeploymentConfig, HTTPOptions
from .controller import CONTROLLER_NAME, ServeController, get_or_create_controller
from .multiplex import get_multiplexed_model_id, multiplexed
from .grpc_proxy import grpc_call, grpc_call_typed, grpc_healthz, grpc_list_applications
from .proxy import ProxyActor, Request
from .replica import get_request_context
from .router import DeploymentHandle, DeploymentResponseGenerator, DeploymentResponse

PROXY_NAME = "SERVE_PROXY"


class Application:
    """A bound deployment graph node (reference serve/_private/build_app.py)."""

    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs


class Deployment:
    def __init__(self, func_or_class, name: str, config: DeploymentConfig):
        self.func_or_class = func_or_class
        self.name = name
        self.config = config

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def options(self, **kw) -> "Deployment":
        import dataclasses

        name = kw.pop("name", self.name)
        # dict spellings accepted everywhere the dataclasses are (config
        # files route through here)
        if isinstance(kw.get("autoscaling_config"), dict):
            kw["autoscaling_config"] = AutoscalingConfig(**kw["autoscaling_config"])
        if isinstance(kw.get("admission"), dict):
            kw["admission"] = AdmissionPolicy(**kw["admission"])
        cfg_kw = {}
        for f in dataclasses.fields(DeploymentConfig):
            if f.name in kw:
                cfg_kw[f.name] = kw.pop(f.name)
        if "ray_actor_options" in kw:  # reference-compat spelling
            opts = kw.pop("ray_actor_options")
            cfg_kw.setdefault("num_cpus", opts.get("num_cpus", self.config.num_cpus))
        if kw:
            raise TypeError(f"unknown deployment options: {sorted(kw)}")
        cfg = dataclasses.replace(self.config, **cfg_kw)
        return Deployment(self.func_or_class, name, cfg)


def deployment(
    _func_or_class: Optional[Any] = None,
    *,
    name: Optional[str] = None,
    num_replicas: Union[int, str, None] = None,
    max_ongoing_requests: int = 8,
    user_config: Optional[Dict[str, Any]] = None,
    autoscaling_config: Optional[Union[AutoscalingConfig, Dict[str, Any]]] = None,
    admission: Optional[Union["AdmissionPolicy", Dict[str, Any]]] = None,
    num_cpus: float = 1.0,
    num_gpus: float = 0.0,
    resources: Optional[Dict[str, float]] = None,
    health_check_period_s: float = 2.0,
    graceful_shutdown_timeout_s: float = 5.0,
    max_restarts: int = 3,
):
    """@serve.deployment decorator (reference serve/api.py deployment)."""

    def deco(func_or_class):
        if isinstance(autoscaling_config, dict):
            asc = AutoscalingConfig(**autoscaling_config)
        else:
            asc = autoscaling_config
        adm = AdmissionPolicy(**admission) if isinstance(admission, dict) else admission
        n_replicas = num_replicas
        if n_replicas == "auto":
            n_replicas = None
        if n_replicas is None:
            n_replicas = asc.min_replicas if asc else 1
        cfg = DeploymentConfig(
            num_replicas=n_replicas,
            max_ongoing_requests=max_ongoing_requests,
            user_config=user_config,
            autoscaling_config=asc,
            admission=adm,
            num_cpus=num_cpus,
            num_gpus=num_gpus,
            resources=resources or {},
            health_check_period_s=health_check_period_s,
            graceful_shutdown_timeout_s=graceful_shutdown_timeout_s,
            max_restarts=max_restarts,
        )
        return Deployment(
            func_or_class,
            name or getattr(func_or_class, "__name__", "deployment"),
            cfg,
        )

    if _func_or_class is not None:
        return deco(_func_or_class)
    return deco


def _collect_deployments(app: Application, out: Dict[str, Application]):
    """DFS the bind graph; Applications nested anywhere in init args (also
    inside lists/tuples/dicts) become handles."""
    name = app.deployment.name
    if name in out and out[name] is not app:
        raise ValueError(f"duplicate deployment name {name!r} in application")
    out[name] = app

    def walk(v):
        if isinstance(v, Application):
            _collect_deployments(v, out)
        elif isinstance(v, (list, tuple)):
            for x in v:
                walk(x)
        elif isinstance(v, dict):
            for x in v.values():
                walk(x)

    for a in list(app.args) + list(app.kwargs.values()):
        walk(a)


def _resolve_arg(a, app_name: str):
    if isinstance(a, Application):
        return {"__ca_serve_handle__": True, "app": app_name, "deployment": a.deployment.name}
    if isinstance(a, list):
        return [_resolve_arg(x, app_name) for x in a]
    if isinstance(a, tuple):
        return tuple(_resolve_arg(x, app_name) for x in a)
    if isinstance(a, dict):
        return {k: _resolve_arg(v, app_name) for k, v in a.items()}
    return a


GRPC_PROXY_NAME = "SERVE_GRPC_PROXY"


def start(http_options: Optional[HTTPOptions] = None, grpc_port: Optional[int] = None, **kw) -> None:
    """Start the Serve system actors (controller + HTTP proxy; pass
    grpc_port to also start the gRPC ingress)."""
    get_or_create_controller()
    opts = http_options or HTTPOptions(**kw)
    try:
        get_actor(PROXY_NAME)
    except Exception:
        from ..core.scheduling_strategies import NodeAffinitySchedulingStrategy as _NA

        Proxy = ca.remote(ProxyActor).options(
            name=PROXY_NAME, lifetime="detached", num_cpus=0.1, max_concurrency=4,
            # the proxy owns live client sockets: pin it to the undrainable
            # head node so a worker-node drain can't restart it mid-stream
            scheduling_strategy=_NA("n0", soft=True),
        )
        h = Proxy.remote(opts.host, opts.port)
        ca.get(h.ready.remote(), timeout=30)
    if grpc_port is not None:
        start_grpc_proxy(port=grpc_port)


def start_grpc_proxy(host: str = "127.0.0.1", port: int = 0) -> str:
    """Start (or find) the gRPC ingress; returns its host:port target."""
    from .grpc_proxy import GrpcProxyActor

    try:
        h = get_actor(GRPC_PROXY_NAME)
    except Exception:
        Proxy = ca.remote(GrpcProxyActor).options(
            name=GRPC_PROXY_NAME, lifetime="detached", num_cpus=0.1, max_concurrency=4
        )
        h = Proxy.remote(host, port)
    return ca.get(h.ready.remote(), timeout=30)


def run(
    app: Application,
    *,
    name: str = "default",
    route_prefix: str = "/",
    _blocking: bool = True,
    wait_timeout_s: float = 60.0,
) -> DeploymentHandle:
    """Deploy an application and return a handle to its ingress
    (reference serve/api.py serve.run)."""
    if not isinstance(app, Application):
        raise TypeError("serve.run expects Deployment.bind(...)")
    ctrl = get_or_create_controller()
    graph: Dict[str, Application] = {}
    _collect_deployments(app, graph)
    specs: List[Dict[str, Any]] = []
    for dname, a in graph.items():
        args = tuple(_resolve_arg(x, name) for x in a.args)
        kwargs = {k: _resolve_arg(v, name) for k, v in a.kwargs.items()}
        specs.append(
            {
                "name": dname,
                "config": pickle.dumps(a.deployment.config),
                "payload": __import__("cloudpickle").dumps(
                    (a.deployment.func_or_class, args, kwargs)
                ),
            }
        )
    ingress = app.deployment.name
    ca.get(
        ctrl.deploy_application.remote(name, route_prefix, ingress, specs), timeout=60
    )
    if _blocking:
        ca.get(ctrl.wait_ready.remote(name, wait_timeout_s), timeout=wait_timeout_s + 10)
    return DeploymentHandle(name, ingress)


def get_app_handle(name: str = "default") -> DeploymentHandle:
    ctrl = get_or_create_controller()
    info = ca.get(ctrl.get_app_route.remote(name))
    if not info["ingress"]:
        raise KeyError(f"no application named {name!r}")
    return DeploymentHandle(name, info["ingress"])


def get_deployment_handle(deployment_name: str, app_name: str = "default") -> DeploymentHandle:
    return DeploymentHandle(app_name, deployment_name)


def status() -> Dict[str, Any]:
    ctrl = get_or_create_controller()
    return ca.get(ctrl.status.remote())

def delete(name: str):
    ctrl = get_or_create_controller()
    ca.get(ctrl.delete_application.remote(name))


def shutdown():
    try:
        ctrl = get_actor(CONTROLLER_NAME)
    except Exception:
        return
    try:
        ca.get(ctrl.shutdown.remote(), timeout=30)
    except Exception:
        pass
    for actor_name in (PROXY_NAME, CONTROLLER_NAME):
        try:
            kill(get_actor(actor_name))
        except Exception:
            pass


__all__ = [
    "deployment",
    "Deployment",
    "Application",
    "run",
    "run_config",
    "start",
    "start_grpc_proxy",
    "grpc_call",
    "grpc_call_typed",
    "grpc_list_applications",
    "grpc_healthz",
    "delete",
    "shutdown",
    "status",
    "get_app_handle",
    "get_deployment_handle",
    "DeploymentHandle",
    "DeploymentResponse",
    "DeploymentConfig",
    "AutoscalingConfig",
    "AdmissionPolicy",
    "HTTPOptions",
    "Request",
    "batch",
    "multiplexed",
    "get_multiplexed_model_id",
    "get_request_context",
]


def run_config(config, *, _blocking: bool = True) -> Dict[str, DeploymentHandle]:
    """Deploy applications from a config file/dict (reference `serve deploy`
    + serve/schema.py ServeDeploySchema, compact):

        applications:
          - name: app1
            route_prefix: /app1
            import_path: my.module:app      # a module-level Application
            deployments:                    # optional per-deployment overrides
              - name: Doubler
                num_replicas: 2

    Returns {app_name: ingress handle}.  import_path targets must be
    importable by replica processes (same host or shipped via runtime_env).
    """
    import importlib

    if isinstance(config, str):
        import yaml

        with open(config) as f:
            config = yaml.safe_load(f) or {}
    handles: Dict[str, DeploymentHandle] = {}
    for app_spec in config.get("applications") or []:
        name = app_spec.get("name", "default")
        module_name, _, attr = app_spec["import_path"].partition(":")
        app = getattr(importlib.import_module(module_name), attr)
        if isinstance(app, Deployment):
            app = app.bind()
        if not isinstance(app, Application):
            raise TypeError(
                f"{app_spec['import_path']} is not an Application/Deployment"
            )
        overrides = {
            d["name"]: {k: v for k, v in d.items() if k != "name"}
            for d in app_spec.get("deployments") or []
        }
        if overrides:
            app = _apply_overrides(app, overrides)
        handles[name] = run(
            app,
            name=name,
            route_prefix=app_spec.get("route_prefix", f"/{name}"),
            _blocking=_blocking,
        )
    return handles


def _apply_overrides(app: Application, overrides: Dict[str, Dict[str, Any]]) -> Application:
    """Rebuild the bind graph with per-deployment option overrides applied."""
    def rebuild(a: Application) -> Application:
        dep = a.deployment
        if dep.name in overrides:
            dep = dep.options(**overrides[dep.name])
        new_args = tuple(rebuild(x) if isinstance(x, Application) else x for x in a.args)
        new_kwargs = {
            k: rebuild(v) if isinstance(v, Application) else v
            for k, v in a.kwargs.items()
        }
        return Application(dep, new_args, new_kwargs)

    return rebuild(app)
