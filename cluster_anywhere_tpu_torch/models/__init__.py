"""The flagship transformer for the port: config, weights, conversion from
the JAX package's params, and the training step.  Prefill, decode and
generation live in models.generate."""

from .convert import from_jax_params, to_jax_params
from .transformer import (
    TransformerConfig,
    TransformerLM,
    cross_entropy_loss,
    forward,
    init_params,
    make_loss_fn,
    make_train_step,
)

__all__ = [
    "TransformerConfig",
    "TransformerLM",
    "init_params",
    "forward",
    "cross_entropy_loss",
    "make_loss_fn",
    "make_train_step",
    "from_jax_params",
    "to_jax_params",
]
