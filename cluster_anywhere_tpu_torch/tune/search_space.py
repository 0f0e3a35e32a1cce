"""Search-space primitives (analogue of python/ray/tune/search/sample.py:
tune.uniform/loguniform/choice/randint/quniform/grid_search/sample_from).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence

import numpy as np


class Domain:
    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, low: float, high: float, log: bool = False, q: float = 0.0):
        if log and low <= 0:
            raise ValueError("loguniform requires low > 0")
        self.low, self.high, self.log, self.q = low, high, log, q

    def sample(self, rng):
        if self.log:
            v = math.exp(rng.uniform(math.log(self.low), math.log(self.high)))
        else:
            v = rng.uniform(self.low, self.high)
        if self.q:
            v = round(v / self.q) * self.q
        return float(v)


class Integer(Domain):
    def __init__(self, low: int, high: int, log: bool = False):
        self.low, self.high, self.log = low, high, log

    def sample(self, rng):
        if self.log:
            return int(math.exp(rng.uniform(math.log(self.low), math.log(self.high))))
        return int(rng.integers(self.low, self.high))


class Categorical(Domain):
    def __init__(self, categories: Sequence[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return self.categories[int(rng.integers(0, len(self.categories)))]


class Function(Domain):
    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn

    def sample(self, rng):
        return self.fn()


class GridSearch:
    """Marker: expanded combinatorially by BasicVariantGenerator, not sampled."""

    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


def uniform(low: float, high: float) -> Float:
    return Float(low, high)


def loguniform(low: float, high: float) -> Float:
    return Float(low, high, log=True)


def quniform(low: float, high: float, q: float) -> Float:
    return Float(low, high, q=q)


def randint(low: int, high: int) -> Integer:
    return Integer(low, high)


def lograndint(low: int, high: int) -> Integer:
    return Integer(low, high, log=True)


def choice(categories: Sequence[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable[[], Any]) -> Function:
    return Function(fn)


def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(values)


def resolve(space: Dict[str, Any], rng: np.random.Generator) -> Dict[str, Any]:
    """Sample every Domain in a (possibly nested) config dict."""
    out = {}
    for k, v in space.items():
        if isinstance(v, Domain):
            out[k] = v.sample(rng)
        elif isinstance(v, dict):
            out[k] = resolve(v, rng)
        else:
            out[k] = v
    return out


def grid_axes(space: Dict[str, Any], prefix=()) -> List[tuple]:
    """All (key_path, values) grid axes in the space."""
    axes = []
    for k, v in space.items():
        if isinstance(v, GridSearch):
            axes.append((prefix + (k,), v.values))
        elif isinstance(v, dict):
            axes.extend(grid_axes(v, prefix + (k,)))
    return axes


def set_path(cfg: Dict[str, Any], path: tuple, value: Any):
    for k in path[:-1]:
        cfg = cfg[k]
    cfg[path[-1]] = value
