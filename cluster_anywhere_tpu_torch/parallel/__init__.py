"""Parallel building blocks of the port.  So far the mixture-of-experts
FFN at ep = 1; meshes, sharding, collectives and the pipeline come with
the parallel-stack slice."""

from .moe import MoEOutput, init_moe_params, moe_ffn, top1_route

__all__ = ["MoEOutput", "moe_ffn", "init_moe_params", "top1_route"]
