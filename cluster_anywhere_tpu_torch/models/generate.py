"""Autoregressive generation with a KV cache for the flagship transformer.

Counterpart of cluster_anywhere_tpu/models/generate.py.  Cache layout as
there, one tensor per K and V stacked over layers:
    k, v: [L, B, T_max, H_kv, D]
Prefill runs the prompt through each block with the flash-attention
dispatcher (the CUDA kernel on the card) and writes the first T columns;
decode steps write column `pos` and attend over each row's live columns,
[pad, pos], through ops.attention.decode_attention (on the card a kernel
that reads only those columns of the cache, in place).  Where the JAX
package scans over layers and donates the cache, this port loops over
layers in Python and updates the cache in place.  Sampling reproduces
jax.random.categorical as argmax(logits + Gumbel noise), the noise drawn
from a torch.Generator on the device, so sampled tokens differ from JAX's
while greedy tokens are the same.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import NEG_INF, attention, decode_attention
from ..parallel.moe import top1_route
from .transformer import (
    TransformerConfig,
    TransformerLM,
    _gqa_repeat,
    _project_qkv,
    _rms_norm,
    _rope,
    _swiglu,
)


def _mlp(bp, x, cfg: TransformerConfig):
    """The FFN with its residual: dense SwiGLU, or with n_experts > 0 the
    serving MoE (_moe_infer), which drops no token."""
    y = _rms_norm(x, bp["ln2"])
    return x + (_moe_infer(bp, y, cfg) if cfg.n_experts else _swiglu(bp, y))


_MOE_CHUNK = 64  # prefill tokens per all-experts pass (bounds [X, B * chunk, F])


def _moe_infer(bp, y, cfg: TransformerConfig):
    """The MoE FFN delta for serving, y: [B, T, E] -> [B, T, E].  Every
    expert is computed and masked by the top-1 route: nothing is dropped
    (capacity binds only in training).  The router's logits are cast to
    fp32 before the softmax, as in the JAX package's serving path (its
    training path stays in the activation dtype).  Prefill runs in chunks of
    _MOE_CHUNK tokens along T, so the all-experts intermediate stays
    bounded; each token's result does not depend on its chunk."""
    n_experts = bp["w_in"].shape[0]

    def dense_pass(y_c):  # [B, c, E] -> [B, c, E]
        b, c, e = y_c.shape
        _, idx, gate = top1_route((y_c @ bp["router"]).float())  # [B, c]
        flat = y_c.reshape(1, b * c, e)
        h = F.silu(flat @ bp["w_in"])  # [X, B * c, F]
        out_x = (h @ bp["w_out"]).reshape(n_experts, b, c, e)
        # the route's expert times its gate: the JAX package's one-hot einsum
        # over the experts, whose other terms are exact zeros
        picked = torch.take_along_dim(out_x, idx[None, :, :, None], dim=0)[0]
        return picked * gate[..., None].to(y_c.dtype)

    t = y.shape[1]
    if t <= _MOE_CHUNK:
        return dense_pass(y)
    return torch.cat([dense_pass(y[:, s:s + _MOE_CHUNK]) for s in range(0, t, _MOE_CHUNK)], dim=1)


def init_cache(cfg: TransformerConfig, batch: int, t_max: int, device):
    shape = (cfg.n_layers, batch, t_max, cfg.n_kv_heads, cfg.d_head)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
    }


def _block_decode(bp, x, layer_cache, pos: int, cfg: TransformerConfig, pad, cols):
    """One block, one token at cache column `pos` for every row.  x: [B, 1, E];
    layer_cache: (k, v) [B, T_max, KV, D], written in place.  pad: [B]
    left-pad counts or None; the token's RoPE position is pos - pad[b].
    cols: the [B] tensors (start, end) of the columns each row attends to,
    the same in every layer."""
    k_cache, v_cache = layer_cache
    y = _rms_norm(x, bp["ln1"])
    q, k, v = _project_qkv(bp, y, cfg)
    if pad is None:
        positions = torch.full((1,), pos, device=x.device)
    else:
        positions = (pos - pad)[:, None]
    q, k = _rope(q, k, positions, cfg)
    k_cache[:, pos] = k[:, 0]
    v_cache[:, pos] = v[:, 0]
    attn = decode_attention(q, k_cache, v_cache, *cols)
    x = x + attn.reshape(x.shape[0], 1, -1) @ bp["wo"]
    return _mlp(bp, x, cfg)


def _block_decode_rowpos(bp, x, layer_cache, pos, cfg: TransformerConfig, pads):
    """One block, one token, PER-ROW cache positions (continuous batching).
    x: [B, 1, E]; pos, pads: [B] long tensors; row b writes column pos[b],
    takes RoPE position pos[b] - pads[b] and attends to [pads[b], pos[b]]
    (an empty range when pads[b] is pos[b] + 1: a free slot's lane)."""
    k_cache, v_cache = layer_cache
    y = _rms_norm(x, bp["ln1"])
    q, k, v = _project_qkv(bp, y, cfg)
    q, k = _rope(q, k, (pos - pads)[:, None], cfg)
    rows = torch.arange(x.shape[0], device=x.device)
    k_cache[rows, pos] = k[:, 0]
    v_cache[rows, pos] = v[:, 0]
    attn = decode_attention(q, k_cache, v_cache, pads, pos + 1)
    x = x + attn.reshape(x.shape[0], 1, -1) @ bp["wo"]
    return _mlp(bp, x, cfg)


def _prefill_block(bp, x, pad, cfg: TransformerConfig, layer_cache):
    """One block over the whole prompt; writes its K/V into the first T
    columns of layer_cache (k, v) [B, T_max, KV, D].  Real tokens sit at
    columns [pad[b], T): their RoPE positions start at 0 and they never
    attend to pad keys.  Attention goes through the dispatcher, i.e. the
    flash kernel with the pad mask on the card."""
    b, t, _ = x.shape
    y = _rms_norm(x, bp["ln1"])
    q, k, v = _project_qkv(bp, y, cfg)
    positions = torch.arange(t, device=x.device)
    if pad is not None:
        positions = (positions[None, :] - pad[:, None]).clamp_min(0)
    q, k = _rope(q, k, positions, cfg)
    k_cache, v_cache = layer_cache
    k_cache[:, :t] = k
    v_cache[:, :t] = v
    attn = attention(q, _gqa_repeat(k, cfg), _gqa_repeat(v, cfg), causal=True, pad=pad)
    x = x + attn.reshape(b, t, -1).to(x.dtype) @ bp["wo"]
    return _mlp(bp, x, cfg)


def prefill(params: TransformerLM, ids, cfg: TransformerConfig, t_max: int, pad=None):
    """ids: [B, T_prompt] -> (last-token logits [B, V] fp32, cache).
    pad: optional [B] left-pad counts (see _prefill_block)."""
    w = params.compute_weights()
    x = w["embed"][ids]
    cache = init_cache(cfg, ids.shape[0], t_max, x.device)
    for i, bp in enumerate(w["blocks"]):
        x = _prefill_block(bp, x, pad, cfg, (cache["k"][i], cache["v"][i]))
    x = _rms_norm(x, w["ln_f"])
    return (x[:, -1] @ w["lm_head"]).float(), cache


def decode_one(params: TransformerLM, cache, token, pos: int, cfg: TransformerConfig, pad=None):
    """token: [B] -> (logits [B, V] fp32, cache updated in place)."""
    w = params.compute_weights()
    x = w["embed"][token][:, None, :]
    b = x.shape[0]
    start = torch.zeros(b, dtype=torch.long, device=x.device) if pad is None else pad
    cols = (start, torch.full((b,), pos + 1, dtype=torch.long, device=x.device))
    for i, bp in enumerate(w["blocks"]):
        x = _block_decode(bp, x, (cache["k"][i], cache["v"][i]), pos, cfg, pad, cols)
    x = _rms_norm(x, w["ln_f"])
    return (x[:, 0] @ w["lm_head"]).float(), cache


def _nucleus_mask(scaled, top_p):
    """Mask logits outside the smallest probability-mass prefix >= top_p.
    top_p: a float or a tensor broadcasting against scaled's rows; values
    <= 0 or >= 1 disable the mask.  The most probable token always stays."""
    probs = torch.softmax(scaled, dim=-1)
    sorted_p = probs.sort(dim=-1, descending=True).values
    cum_excl = sorted_p.cumsum(dim=-1) - sorted_p
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=scaled.device)
    thresh = torch.where(cum_excl < top_p, sorted_p, torch.full_like(sorted_p, float("inf")))
    thresh = thresh.amin(dim=-1, keepdim=True)
    apply = (top_p > 0.0) & (top_p < 1.0)
    return torch.where(apply & (probs < thresh), torch.full_like(scaled, NEG_INF), scaled)


def _gumbel_argmax(scaled, generator: Optional[torch.Generator]):
    """argmax(scaled + Gumbel noise): the categorical sample
    jax.random.categorical draws, per row of scaled [..., V]."""
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return (scaled - torch.log(-torch.log(u))).argmax(dim=-1).to(torch.int32)


def _sample(logits, generator: Optional[torch.Generator], temperature: float, top_k: int,
            top_p: float = 1.0):
    """temperature <= 0 is greedy; top_k > 0 keeps the k largest logits;
    top_p in (0, 1) applies the nucleus mask."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    if temperature <= 0.0:
        return greedy
    scaled = logits / max(float(temperature), 1e-6)
    if top_k > 0:
        top = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < top, torch.full_like(scaled, NEG_INF), scaled)
    if 0.0 < float(top_p) < 1.0:
        scaled = _nucleus_mask(scaled, top_p)
    return _gumbel_argmax(scaled, generator)


def _prepare(params: TransformerLM, prompt_ids, prompt_lens, max_new_tokens: int):
    dev = params.device
    ids = torch.as_tensor(prompt_ids, device=dev).long()
    t_prompt = ids.shape[1]
    pad = None
    if prompt_lens is not None:
        pad = t_prompt - torch.as_tensor(prompt_lens, device=dev).long()
    return ids, pad, t_prompt, t_prompt + max_new_tokens


@torch.no_grad()
def generate(
    params: TransformerLM,
    prompt_ids,
    generator: Optional[torch.Generator] = None,
    *,
    cfg: TransformerConfig,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    prompt_lens=None,
) -> torch.Tensor:
    """prompt_ids: [B, T_prompt] -> generated ids [B, max_new_tokens] int32.
    Prefill, then max_new_tokens - 1 decode steps.  prompt_lens: optional
    [B] count of real (rightmost) tokens per row when prompts are
    left-padded to T_prompt; pads are masked and RoPE counts real tokens.
    generator seeds the sampling noise (unused when greedy)."""
    ids, pad, t_prompt, t_max = _prepare(params, prompt_ids, prompt_lens, max_new_tokens)
    logits, cache = prefill(params, ids, cfg, t_max, pad)
    token = _sample(logits, generator, temperature, top_k, top_p)
    out = [token]
    for pos in range(t_prompt, t_max - 1):
        logits, cache = decode_one(params, cache, token, pos, cfg, pad)
        token = _sample(logits, generator, temperature, top_k, top_p)
        out.append(token)
    return torch.stack(out, dim=1)


def stream_generate(
    params: TransformerLM,
    prompt_ids,
    generator: Optional[torch.Generator] = None,
    *,
    cfg: TransformerConfig,
    max_new_tokens: int = 32,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    prompt_lens=None,
) -> Iterator[np.ndarray]:
    """Yields one [B] int32 numpy array per sampled token, as soon as it is
    sampled: the streaming counterpart of generate(), same tokens."""
    with torch.no_grad():
        ids, pad, t_prompt, t_max = _prepare(params, prompt_ids, prompt_lens, max_new_tokens)
        logits, cache = prefill(params, ids, cfg, t_max, pad)
        token = _sample(logits, generator, temperature, top_k, top_p)
    yield token.cpu().numpy()
    for pos in range(t_prompt, t_max - 1):
        with torch.no_grad():
            logits, cache = decode_one(params, cache, token, pos, cfg, pad)
            token = _sample(logits, generator, temperature, top_k, top_p)
        yield token.cpu().numpy()
