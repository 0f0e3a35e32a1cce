"""The flagship transformer for the port: config, weights, conversion from
the JAX package's params, the training step, and its sharding on a mesh.  Prefill, decode and
generation live in models.generate."""

from .convert import (
    from_jax_params,
    load_train_state,
    to_jax_params,
    train_state,
    train_state_specs,
)
from .transformer import (
    TransformerConfig,
    TransformerLM,
    cross_entropy_loss,
    forward,
    init_params,
    make_batch_sharding,
    make_loss_fn,
    make_train_step,
    param_specs,
    shard_params,
)

__all__ = [
    "TransformerConfig",
    "TransformerLM",
    "init_params",
    "forward",
    "cross_entropy_loss",
    "make_loss_fn",
    "make_train_step",
    "make_batch_sharding",
    "param_specs",
    "shard_params",
    "from_jax_params",
    "to_jax_params",
    "train_state",
    "train_state_specs",
    "load_train_state",
]
