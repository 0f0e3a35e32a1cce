"""The plain reference: the decoder the configurations describe, in plain
PyTorch and float32 (TF32 off), with no kernel, cache or batching, computed
layer by layer or in blocks of tokens so that it fits beside nothing else on
the card.  It imports nothing of the program.

The block is LLaMA's as DeepSeek LLM publishes it: RMSNorm (eps from the
configuration), multi-head attention with rotary embeddings (interleaved
pairs, as the configuration's `assumed` says), causal softmax, SwiGLU.

`precision` puts a lower precision in place of float32 for the control:
"bf16" or "fp8" rounds every matrix product's operands (weights,
activations, and in the backward the incoming gradients) to that type
first; fp8 is e4m3 forward and e5m2 backward, each tensor scaled to its
largest magnitude.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from . import weights as W

_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def _round(x, fmt: str, backward: bool = False):
    if fmt == "fp32":
        return x
    if fmt == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if fmt == "fp8":
        t = torch.float8_e5m2 if backward else torch.float8_e4m3fn
        amax = x.detach().abs().amax().float().clamp_min(1e-30)
        scale = _FP8_MAX[t] / amax
        return ((x.float() * scale).to(t).float() / scale).to(x.dtype)
    raise ValueError(f"unknown precision {fmt!r}")


class _Round(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt):
        ctx.fmt = fmt
        return _round(x, fmt)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.fmt, backward=True), None


def _q(x, fmt):
    if fmt == "fp32":
        return x
    return _Round.apply(x, fmt) if torch.is_grad_enabled() and x.requires_grad else _round(x, fmt)


def mm(a, b, fmt="fp32"):
    return _q(a, fmt) @ _q(b, fmt)


def strict_fp32() -> None:
    """float32 products in float32: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """x [T, H, D] (or [B, T, H, D]); rotate pairs (2i, 2i+1) by
    position * theta^(-2i/D)."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.float()[:, None] * freqs  # [T, D/2]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape)


def _attention(q, k, v, fmt):
    t = q.shape[1]
    s = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1), fmt) / math.sqrt(q.shape[-1])
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    return mm(torch.softmax(s, dim=-1), v.transpose(1, 2), fmt).transpose(1, 2)


def attention(q, k, v, fmt="fp32", heads_per_chunk: int = 8):
    """Causal softmax attention, q, k, v [B, T, H, D] -> [B, T, H, D];
    k and v carry n_kv_heads heads, each serving n_heads / n_kv_heads
    query heads.  Computed a few heads at a time (each chunk recomputed in
    the backward), so that the [T, T] scores of only a few heads live at
    once."""
    from torch.utils.checkpoint import checkpoint

    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    outs = []
    for h in range(0, q.shape[2], heads_per_chunk):
        qc, kc, vc = (x[:, :, h:h + heads_per_chunk] for x in (q, k, v))
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attention, qc, kc, vc, fmt, use_reentrant=False))
        else:
            outs.append(_attention(qc, kc, vc, fmt))
    return torch.cat(outs, dim=2)


def block(x, p: Dict, m: Dict, fmt="fp32"):
    """One decoder block over x [B, T, E] (positions 0..T-1)."""
    b, t, _ = x.shape
    h, kv, d = m["n_heads"], m["n_kv_heads"], m["d_head"]
    y = rms_norm(x, p["ln1"], m["eps"])
    pos = torch.arange(t, device=x.device)
    q = rope(mm(y, p["wq"], fmt).reshape(b, t, h, d), pos, m["rope_theta"])
    k = rope(mm(y, p["wk"], fmt).reshape(b, t, kv, d), pos, m["rope_theta"])
    v = mm(y, p["wv"], fmt).reshape(b, t, kv, d)
    x = x + mm(attention(q, k, v, fmt).reshape(b, t, h * d), p["wo"], fmt)
    y = rms_norm(x, p["ln2"], m["eps"])
    return x + mm(F.silu(mm(y, p["w_gate"], fmt)) * mm(y, p["w_up"], fmt), p["w_down"], fmt)


def _layer(w: Dict, i: int) -> Dict:
    return {k: w[k][i].float() for k in W.BLOCK_KINDS}


@torch.no_grad()
def served_logits(w: Dict, m: Dict, seqs: Sequence[Sequence[int]], rows: Sequence[Sequence[int]],
                  fmt: str = "fp32") -> List[torch.Tensor]:
    """For each token sequence, the fp32 logits [len(rows_i), V] at the
    positions rows_i.  w: the weights (any float dtype; each layer is cast
    to float32 at its use).  One sequence at a time, layer by layer."""
    dev = w["embed"].device
    head = w["lm_head"].float()
    out = []
    for ids, r in zip(seqs, rows):
        x = w["embed"][torch.as_tensor(list(ids), device=dev)].float()[None]
        for i in range(m["n_layers"]):
            x = block(x, _layer(w, i), m, fmt)
        y = rms_norm(x[0, torch.as_tensor(list(r), device=dev)], w["ln_f"].float(), m["eps"])
        out.append(mm(y, head, fmt))
    return out


# ---------------------------------------------------------------- training


def loss_fn(params: Dict, ids, m: Dict, fmt: str = "fp32", chunk: int = 1024):
    """Mean next-token cross-entropy of ids [B, T + 1]; each block and each
    chunk of the head's tokens recomputed in the backward (activation
    checkpointing), so that an 8-layer 4096-token batch fits in fp32."""
    from torch.utils.checkpoint import checkpoint

    inputs, targets = ids[:, :-1], ids[:, 1:]
    x = params["embed"][inputs]
    for i in range(m["n_layers"]):
        p = {k: params[k][i] for k in W.BLOCK_KINDS}
        x = checkpoint(block, x, p, m, fmt, use_reentrant=False)

    def head_nll(xc, tc):
        y = rms_norm(xc, params["ln_f"], m["eps"])
        logits = mm(y, params["lm_head"], fmt)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), tc.reshape(-1), reduction="sum")

    total = 0.0
    t = inputs.shape[1]
    for s in range(0, t, chunk):
        total = total + checkpoint(head_nll, x[:, s:s + chunk], targets[:, s:s + chunk],
                                   use_reentrant=False)
    return total / targets.numel()


class AdamW:
    """Decoupled weight decay, then Adam with bias correction: torch.optim.
    AdamW's update (and optax.adamw's), written out."""

    def __init__(self, params: Dict, lr: float, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.01):
        self.params, self.lr, self.b1, self.b2 = params, lr, betas[0], betas[1]
        self.eps, self.wd, self.t = eps, weight_decay, 0
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self):
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = p.grad
            p.mul_(1 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)
            p.grad = None


def leaf_norms(t: Dict, m: Dict) -> Dict[str, float]:
    """The norm of every leaf (a kind's layer slice), by the port's names."""
    return {name: float(W.pick(t[kind], i).norm()) for name, kind, i in W.leaves(m)}


def train_readings(m: Dict, seed: int, batches: Sequence, lr: float, weight_decay: float,
                   device, fmt: str = "fp32", steps: int = 3) -> Dict:
    """The reference's run of the first `steps` steps from the seed's
    weights: each step's loss, every leaf's first gradient norm, and every
    leaf's change after the steps.  batches[k] is step k+1's ids."""
    params = {k: W.make(m, seed, k, device, torch.float32).requires_grad_() for k in W.KINDS}
    opt = AdamW(params, lr, weight_decay=weight_decay)
    losses, grad_norms = [], None
    for s in range(steps):
        loss = loss_fn(params, batches[s], m, fmt)
        loss.backward()
        losses.append(float(loss.detach()))
        if s == 0:
            grad_norms = leaf_norms({k: p.grad for k, p in params.items()}, m)
        opt.step()
    del opt
    change = {}
    with torch.no_grad():
        for k in W.KINDS:
            p0 = W.make(m, seed, k, device, torch.float32)
            change.update({name: float((W.pick(params[k], i) - W.pick(p0, i)).norm())
                           for name, kind, i in W.leaves(m) if kind == k})
            del p0
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
