"""The yardstick's arithmetic: the H100's published peaks, the least time a
piece of work can take on it, and the operations and bytes each piece of the
timed paths needs, from its shapes.

Copied from chip_smoke.py (`bound_ms`, `HBM_BYTES_S`, `BF16_FLOPS`,
`model_flops_per_step`, the flash forward and backward counts of
`phase_kernel_timing` and `phase_bwd_timing`) and extended to MHA or GQA
widths, left-padded prompts counted by their real tokens, and a decode
step's reads at the live slots' real lengths.  `m` is a dict of
manifest.model_dims.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

# NVIDIA H100 SXM data sheet, dense rates at the 700-W limit
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12


def bound_ms(nbytes: float, flops: float) -> Tuple[float, str]:
    """The least time the card could take: bytes over the HBM rate or the
    products over the bf16 tensor-core peak, whichever is longer; and which."""
    t_bytes, t_flops = nbytes / HBM_BYTES_S * 1e3, flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def block_matmul_params(m: Dict) -> int:
    """Weights of one block's matrix products (q, k, v, o and the SwiGLU)."""
    e, h, kv, d, f = m["d_model"], m["n_heads"], m["n_kv_heads"], m["d_head"], m["d_ff"]
    return e * h * d + 2 * e * kv * d + h * d * e + 3 * e * f


def n_params(m: Dict) -> int:
    """Every parameter: embedding, blocks (with their two norms), final norm, head."""
    e = m["d_model"]
    return 2 * m["vocab"] * e + m["n_layers"] * (block_matmul_params(m) + 2 * e) + e


def causal_pairs(n: int) -> int:
    """(query, key) pairs a causal mask keeps over n tokens."""
    return n * (n + 1) // 2


def model_flops_per_step(m: Dict, b: int, t: int, causal_discount: bool = True) -> float:
    """chip_smoke.py's count: 3x the forward's matmul FLOPs (the backward is
    about 2x the forward), the attention term halved under the causal
    discount."""
    e, h, d, L, v = m["d_model"], m["n_heads"], m["d_head"], m["n_layers"], m["vocab"]
    per_tok_layer = 2 * block_matmul_params(m)
    attn_per_seq_layer = 4 * t * t * d * h * (0.5 if causal_discount else 1.0)
    fwd = b * t * per_tok_layer * L + b * attn_per_seq_layer * L + b * t * 2 * e * v
    return 3 * fwd


def prefill_flops(m: Dict, n: int) -> float:
    """What one prompt of n real tokens needs: every block's products over
    its n tokens, causal attention over their pairs (QK^T and PV), and the
    head over the last token, whose logits give the first token."""
    h, d, L = m["n_heads"], m["d_head"], m["n_layers"]
    return (n * L * 2 * block_matmul_params(m) + L * 4 * d * h * causal_pairs(n)
            + 2 * m["d_model"] * m["vocab"])


def decode_step_flops(m: Dict, live: int, kv_tokens: int) -> float:
    """What one decode step needs for its live slots: every block's products
    and the head over one token each, and attention (QK^T and PV) over the
    slots' real lengths (kv_tokens summed over them)."""
    h, d, L = m["n_heads"], m["d_head"], m["n_layers"]
    return (live * (L * 2 * block_matmul_params(m) + 2 * m["d_model"] * m["vocab"])
            + L * 4 * d * h * kv_tokens)


def decode_step_bytes(m: Dict, live: int, kv_tokens: int, elt: int = 2) -> float:
    """What one decode step needs from HBM: every block's weights and the
    head once, the live slots' embedding rows, their K/V at their real
    lengths (kv_tokens summed over the live slots, the new token included)
    and the new K/V written."""
    e, kv, d, L = m["d_model"], m["n_kv_heads"], m["d_head"], m["n_layers"]
    weights = L * (block_matmul_params(m) + 2 * e) + e + e * m["vocab"]
    kv_row = L * 2 * kv * d  # K and V of one token over the layers
    return elt * (weights + live * e + kv_tokens * kv_row + live * kv_row)


def flash_fwd_cost(h: int, d: int, lens: Iterable[int], elt: int = 2,
                   with_lse: bool = False) -> Tuple[float, float]:
    """(FLOPs, bytes) of the causal forward over rows of the given real
    lengths: QK^T and PV over each row's causal pairs; q, k, v read and o
    written once for the real tokens (pad columns need nothing), and the LSE
    in fp32 when returned."""
    flops = nbytes = 0.0
    for n in lens:
        flops += 2 * 2 * d * h * causal_pairs(n)
        nbytes += 4 * n * h * d * elt + (n * h * 4 if with_lse else 0)
    return flops, nbytes


def flash_bwd_costs(b: int, t: int, h: int, d: int, elt: int = 2) -> Dict[str, Tuple[float, float]]:
    """(FLOPs, bytes) of each backward kernel at a causal [b, t, h, d]
    shape, as chip_smoke.py counts them: dQ needs S = QK^T, dP = dO V^T and
    dS K (3 products) from q, k, v, dO, LSE and delta, writing dQ; dK/dV
    needs S, dP, P^T dO and dS^T Q (4 products) and writes dK, dV."""
    pairs = b * h * causal_pairs(t)
    row = b * t * h * d * elt
    stats = b * h * t * 4

    def cost(n_products, n_in, n_stats, n_out):
        return n_products * 2 * d * pairs, (n_in + n_out) * row + n_stats * stats

    return {"dq": cost(3, 4, 2, 1), "dkv": cost(4, 4, 2, 2)}
