"""Kernels of the port and their plain PyTorch versions."""

from .attention import attention, flash_attention, flash_attention_bwd, reference_attention

__all__ = ["attention", "flash_attention", "flash_attention_bwd", "reference_attention"]
