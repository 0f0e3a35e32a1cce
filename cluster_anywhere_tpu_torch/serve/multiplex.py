"""Model multiplexing (analogue of python/ray/serve/multiplex.py
_ModelMultiplexWrapper + serve.get_multiplexed_model_id): one replica serves
many models, loading on demand with LRU eviction.
"""

from __future__ import annotations

import asyncio
import functools
from collections import OrderedDict
from typing import Any, Callable, Optional

from .replica import get_request_context


def get_multiplexed_model_id() -> str:
    return get_request_context().multiplexed_model_id


def multiplexed(_fn: Optional[Callable] = None, *, max_num_models_per_replica: int = 3):
    """Decorate an async model loader: `async def load(self, model_id): ...`.
    Calls are cached per model id with LRU eviction."""

    def deco(fn):
        # cache+lock live on the instance (a module-level id()-keyed dict
        # would pin every instance forever); free functions get one shared slot
        attr = f"__ca_mux_{fn.__qualname__.replace('.', '_')}"
        free_state: dict = {}

        @functools.wraps(fn)
        async def wrapper(*args):
            if len(args) == 2:
                self_obj, model_id = args
                state = getattr(self_obj, attr, None)
                if state is None:
                    state = {"cache": OrderedDict(), "locks": {}}
                    setattr(self_obj, attr, state)
            else:
                (model_id,) = args
                self_obj = None
                if not free_state:
                    free_state.update(cache=OrderedDict(), locks={})
                state = free_state
            cache = state["cache"]
            if model_id in cache:  # cache hits never wait behind a load
                cache.move_to_end(model_id)
                return cache[model_id]
            # loads serialize per model id only: a slow load of model B must
            # not block requests for cached model A or a parallel load of C
            lock = state["locks"].setdefault(model_id, asyncio.Lock())
            async with lock:
                if model_id in cache:
                    cache.move_to_end(model_id)
                    return cache[model_id]
                try:
                    model = await (
                        fn(self_obj, model_id) if self_obj is not None else fn(model_id)
                    )
                except BaseException:
                    # never cached: drop the lock entry too, or a stream of
                    # failing ids grows the dict forever
                    state["locks"].pop(model_id, None)
                    raise
                cache[model_id] = model
                while len(cache) > max_num_models_per_replica:
                    old_id, _ = cache.popitem(last=False)  # LRU; refcount GC cleans up
                    state["locks"].pop(old_id, None)
                return model

        wrapper._is_serve_multiplexed = True
        return wrapper

    if _fn is not None:
        return deco(_fn)
    return deco
