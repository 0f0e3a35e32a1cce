"""DAG node types (analogue of the reference's ray.dag dag_node.py /
input_node.py / class_node.py / function_node.py / output_node.py)."""

from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional, Tuple

_node_counter = itertools.count()


class DAGNode:
    """Base: an operation whose bound args may include other DAGNodes."""

    def __init__(self, args: Tuple = (), kwargs: Optional[Dict[str, Any]] = None):
        self._bound_args = tuple(args)
        self._bound_kwargs = dict(kwargs or {})
        self._id = next(_node_counter)
        self._tensor_transport = False

    def with_tensor_transport(self) -> "DAGNode":
        """Mark this node's output as tensor data: tensor leaves cross the
        channel as raw host buffers out of band (channel/device_transport),
        never through pickle bytes, and land on the consumer's device
        (`cuda:<current>` where a GPU is visible, else the CPU); numpy and
        CPU-tensor leaves land there too.  A DTensor leaf keeps its
        placements and lands over the consumer's registered mesh.

        Counterpart of the reference's
        experimental/channel/torch_tensor_nccl_channel.py:44 transport
        annotation, staged through the host: one device-to-host copy on
        the producer, one scatter-write into shm, one host-to-device copy
        on the consumer."""
        self._tensor_transport = True
        return self

    # -- graph introspection ------------------------------------------------

    def _upstream(self) -> List["DAGNode"]:
        ups = []
        for a in list(self._bound_args) + list(self._bound_kwargs.values()):
            if isinstance(a, DAGNode):
                ups.append(a)
        return ups

    def _walk(self, seen=None) -> List["DAGNode"]:
        """Topological order (deps first)."""
        if seen is None:
            seen = {}
        if self._id in seen:
            return []
        seen[self._id] = self
        out = []
        for u in self._upstream():
            out.extend(u._walk(seen))
        out.append(self)
        return out

    # -- eager execution ----------------------------------------------------

    def execute(self, *input_args, **input_kwargs):
        """Recursively execute by submitting tasks/actor calls; DAGNode args
        are passed as ObjectRefs so the runtime chains them without a driver
        round-trip per hop."""
        cache: Dict[int, Any] = {}

        def run(node: DAGNode):
            if node._id in cache:
                return cache[node._id]
            args = [run(a) if isinstance(a, DAGNode) else a for a in node._bound_args]
            kwargs = {
                k: run(v) if isinstance(v, DAGNode) else v
                for k, v in node._bound_kwargs.items()
            }
            cache[node._id] = node._execute_impl(args, kwargs, input_args, input_kwargs)
            return cache[node._id]

        return run(self)

    def _execute_impl(self, args, kwargs, input_args, input_kwargs):
        raise NotImplementedError

    def experimental_compile(self, *, max_inflight_executions: int = 2,
                             buffer_size: Optional[int] = None,
                             execute_timeout_s: Optional[float] = None):
        from .compiled import CompiledDAG

        return CompiledDAG(
            self, max_inflight_executions=max_inflight_executions,
            buffer_size=buffer_size, execute_timeout_s=execute_timeout_s,
        )

    def visualize(self) -> str:
        """ASCII rendering of the graph (reference: dag/vis_utils.py)."""
        lines = []
        for n in self._walk():
            ups = ", ".join(str(u._id) for u in n._upstream()) or "-"
            lines.append(f"[{n._id}] {n._label()}  <- {ups}")
        return "\n".join(lines)

    def _label(self) -> str:
        return type(self).__name__


class InputNode(DAGNode):
    """The DAG's input placeholder; supports `with InputNode() as inp:` and
    `inp[0]` / `inp.key` attribute access (reference: dag/input_node.py)."""

    def __init__(self):
        super().__init__()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __getitem__(self, key):
        return InputAttributeNode(self, key)

    def __getattr__(self, key):
        if key.startswith("_"):
            raise AttributeError(key)
        return InputAttributeNode(self, key)

    def _execute_impl(self, args, kwargs, input_args, input_kwargs):
        if input_kwargs or len(input_args) != 1:
            return tuple(input_args) if not input_kwargs else (input_args, input_kwargs)
        return input_args[0]

    def _label(self):
        return "Input"


class InputAttributeNode(DAGNode):
    def __init__(self, input_node: InputNode, key):
        super().__init__(args=(input_node,))
        self._key = key

    def _execute_impl(self, args, kwargs, input_args, input_kwargs):
        if isinstance(self._key, int):
            return input_args[self._key]
        if self._key in input_kwargs:
            return input_kwargs[self._key]
        return args[0][self._key]

    def _label(self):
        return f"Input[{self._key!r}]"


class FunctionNode(DAGNode):
    """A task node, from RemoteFunction.bind()."""

    def __init__(self, remote_fn, args, kwargs):
        super().__init__(args, kwargs)
        self._remote_fn = remote_fn

    def _execute_impl(self, args, kwargs, input_args, input_kwargs):
        return self._remote_fn.remote(*args, **kwargs)

    def _label(self):
        return f"task:{self._remote_fn.underlying.__name__}"


class ClassMethodNode(DAGNode):
    """An actor-method node, from ActorMethod.bind()."""

    def __init__(self, actor_handle, method_name: str, args, kwargs):
        super().__init__(args, kwargs)
        self._actor = actor_handle
        self._method_name = method_name

    def _execute_impl(self, args, kwargs, input_args, input_kwargs):
        return getattr(self._actor, self._method_name).remote(*args, **kwargs)

    def _label(self):
        return f"{self._actor!r}.{self._method_name}"


class MultiOutputNode(DAGNode):
    """Aggregates several leaf nodes into a tuple output (reference:
    dag/output_node.py)."""

    def __init__(self, outputs: List[DAGNode]):
        super().__init__(args=tuple(outputs))

    def _execute_impl(self, args, kwargs, input_args, input_kwargs):
        return list(args)

    def _label(self):
        return "MultiOutput"
