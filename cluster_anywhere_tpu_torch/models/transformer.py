"""The flagship decoder-only transformer (LLaMA-style) for the port: its
config, its weights as an nn.Module, the block helpers serving and
training share, and the training step.

Counterpart of cluster_anywhere_tpu/models/transformer.py.  Weights keep
the JAX names and the JAX [in, out] layout (the code reads `y @ W`), and
are trainable fp32 masters as there.  `forward` casts each master to the
activation dtype at its use, through autograd, as the JAX forward does;
the serving path uses a copy cast once per weight update
(`TransformerLM.compute_weights`), which equals that cast because the
cast is deterministic.  Training runs on one device with AdamW
(`make_train_step`).  With n_experts > 0 every block's FFN is a top-1
mixture of experts (parallel/moe.py) with all experts on this device
(ep = 1); pipeline/sequence/expert parallelism are a later slice, and
their config values raise until then.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from .._device import resolve_device
from ..ops.attention import attention, flash_attention, reference_attention
from ..parallel.moe import init_moe_params, moe_ffn

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def as_torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ("bfloat16", "float32")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).rsplit(".", 1)[-1]
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


_PARALLEL_ITEM = "3"  # ROADMAP Queue 1 item: the parallel stack


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's config, field for field.  Values that mean one
    device run; the others raise NotImplementedError naming the parallel
    stack's ROADMAP item.

    attn_impl: the training forward's attention.  "auto" and "dense" take
    the dispatcher (the flash kernels on the card), "flash" forces
    flash_attention (its plain version on the CPU), "jnp" the dense
    reference_attention; "ring" and "ulysses" need sp > 1.
    flash_block_q/k: accepted and ignored, since the Hopper kernels' tiles
    are fixed (ops/csrc/flash_sm90.cuh).  remat recomputes each block in
    the backward (torch.utils.checkpoint, the jax.checkpoint of the JAX
    forward).  unroll_layers has no effect: eager layers are never a
    rolled loop."""

    vocab_size: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_head: int = 64
    d_ff: int = 1408
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    dtype: Any = torch.bfloat16  # activation/compute dtype
    param_dtype: Any = torch.float32
    attn_impl: str = "auto"  # auto | dense | flash | jnp (ring | ulysses not ported)
    flash_block_q: Any = None
    flash_block_k: Any = None
    pp: int = 1
    sp: int = 1
    num_microbatches: int = 1
    remat: bool = False
    unroll_layers: bool = True
    # mixture-of-experts FFN (parallel/moe.py, switch-style top-1): every
    # block's dense FFN becomes n_experts experts.  0 = dense.
    n_experts: int = 0
    ep: int = 1  # expert-parallel devices: only 1 is ported
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_torch_dtype(self.dtype))
        object.__setattr__(self, "param_dtype", as_torch_dtype(self.param_dtype))
        if self.ep != 1:
            raise NotImplementedError(
                f"expert parallelism ep={self.ep} is not ported: the all_to_all exchange over a "
                "process group comes with the parallel-stack slice (ROADMAP Queue 1 item "
                f"{_PARALLEL_ITEM}); use ep=1 (all experts on one device)")
        for name in ("pp", "sp", "num_microbatches"):
            if getattr(self, name) != 1:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)} is not ported: pipeline and sequence "
                    f"parallelism come with the parallel stack (ROADMAP Queue 1 item "
                    f"{_PARALLEL_ITEM}); use {name}=1")
        if self.attn_impl in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attn_impl={self.attn_impl!r} is not ported: sequence-parallel attention comes "
                f"with the parallel stack (ROADMAP Queue 1 item {_PARALLEL_ITEM})")
        if self.attn_impl not in _ATTENTION:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} not a multiple of n_kv_heads {self.n_kv_heads}")


_ATTENTION = {
    "auto": attention,
    "dense": attention,
    "flash": flash_attention,
    "jnp": reference_attention,
}


def block_shapes(cfg: TransformerConfig) -> Dict[str, Tuple[int, ...]]:
    """Each block weight's name and shape, in the JAX package's order: the
    attention weights and norms, then the dense SwiGLU (w_gate, w_up,
    w_down) or, with n_experts > 0, the router and the experts."""
    e, f, x = cfg.d_model, cfg.d_ff, cfg.n_experts
    shapes = {
        "ln1": (e,),
        "wq": (e, cfg.n_heads * cfg.d_head),
        "wk": (e, cfg.n_kv_heads * cfg.d_head),
        "wv": (e, cfg.n_kv_heads * cfg.d_head),
        "wo": (cfg.n_heads * cfg.d_head, e),
        "ln2": (e,),
    }
    if x:
        shapes.update(router=(e, x), w_in=(x, e, f), w_out=(x, f, e))
    else:
        shapes.update(w_gate=(e, f), w_up=(e, f), w_down=(f, e))
    return shapes


class TransformerBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        for name, shape in block_shapes(cfg).items():
            self.register_parameter(
                name,
                nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device)),
            )


class TransformerLM(nn.Module):
    """Holds the weights: embed [V, E], blocks[i].{block_keys}, ln_f [E],
    lm_head [E, V]; block_keys are block_shapes(cfg)'s names."""

    def __init__(self, cfg: TransformerConfig, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        pd = cfg.param_dtype

        def param(*shape):
            return nn.Parameter(torch.empty(shape, dtype=pd, device=dev))

        self.embed = param(cfg.vocab_size, cfg.d_model)
        self.blocks = nn.ModuleList(TransformerBlock(cfg, dev) for _ in range(cfg.n_layers))
        self.ln_f = param(cfg.d_model)
        self.lm_head = param(cfg.d_model, cfg.vocab_size)
        self._compute: Optional[Dict[str, Any]] = None
        self._compute_key: Optional[Tuple[int, ...]] = None
        self.block_keys = tuple(block_shapes(cfg))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def compute_weights(self) -> Dict[str, Any]:
        """The weights in the activation dtype, detached, for serving:
        {"embed", "blocks": [{name: tensor}], "ln_f", "lm_head"}.  Cast once
        and kept until a weight changes in place (an optimizer step, a
        load): the cache is keyed on the parameters' version counters.  With
        fp32 activations these are the masters themselves."""
        key = tuple(p._version for p in self.parameters())
        if self._compute is None or key != self._compute_key:
            dt = self.cfg.dtype
            self._compute_key = key
            self._compute = {
                "embed": self.embed.detach().to(dt),
                "blocks": [
                    {n: getattr(blk, n).detach().to(dt) for n in self.block_keys}
                    for blk in self.blocks
                ],
                "ln_f": self.ln_f.detach().to(dt),
                "lm_head": self.lm_head.detach().to(dt),
            }
        return self._compute


def init_params(cfg: TransformerConfig, generator: Union[int, torch.Generator] = 0,
                device=None) -> TransformerLM:
    """Random weights with the JAX package's scales (normal * fan_in^-0.5,
    embed * 0.02, norms 1; the MoE weights init_moe_params' scales), drawn
    from a seeded torch.Generator on the target device.  The numbers differ
    from jax.random's for the same seed; tests that need both packages on
    one set of weights convert the JAX params with
    models.convert.from_jax_params."""
    dev = resolve_device(device)
    model = TransformerLM(cfg, dev)
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=dev).manual_seed(int(generator))

    def normal_(p, std):
        p.copy_(torch.randn(p.shape, generator=gen, device=dev, dtype=p.dtype) * std)

    with torch.no_grad():
        normal_(model.embed, 0.02)
        for blk in model.blocks:
            moe = {}
            if cfg.n_experts:
                moe = init_moe_params(gen, cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.param_dtype,
                                      dev)
            for name in model.block_keys:
                p = getattr(blk, name)
                if name in moe:
                    p.copy_(moe[name])
                elif name.startswith("ln"):
                    p.fill_(1.0)
                else:
                    normal_(p, p.shape[0] ** -0.5)
        model.ln_f.fill_(1.0)
        normal_(model.lm_head, cfg.d_model ** -0.5)
    return model


def _rms_norm(x, w, eps: float = 1e-6):
    """Variance in fp32; the rsqrt is cast to x's dtype before it scales x."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w.to(x.dtype)


def _rope(q, k, positions, cfg: TransformerConfig):
    """Interleaved rotary embeddings over (0::2, 1::2) pairs, in fp32.
    q, k: [B, T, H, D]; positions: [T] global positions, or [B, T] per-row
    positions (left-padded prompts start each row's real tokens at 0)."""
    d = cfg.d_head
    freqs = cfg.rope_theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=q.device) / d)
    angles = positions.to(torch.float32)[..., None] * freqs  # [..., T, D/2]
    if angles.dim() == 2:
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]  # [B|1, T, 1, D/2]
    sin = torch.sin(angles)[:, :, None, :]

    def rot(x):
        x1, x2 = x[..., 0::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).reshape(x.shape)

    return rot(q.float()).to(q.dtype), rot(k.float()).to(k.dtype)


def _project_qkv(bp, y, cfg: TransformerConfig):
    b, t, _ = y.shape
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (y @ bp["wq"]).reshape(b, t, h, d)
    k = (y @ bp["wk"]).reshape(b, t, kv, d)
    v = (y @ bp["wv"]).reshape(b, t, kv, d)
    return q, k, v


def _gqa_repeat(x, cfg: TransformerConfig):
    """Repeat each K/V head n_heads / n_kv_heads times in place along the
    heads axis (jnp.repeat semantics, i.e. repeat_interleave), written as
    an expand + reshape."""
    if cfg.n_kv_heads != cfg.n_heads:
        b, t, kv, d = x.shape
        rep = cfg.n_heads // kv
        x = x[:, :, :, None, :].expand(b, t, kv, rep, d).reshape(b, t, kv * rep, d)
    return x


def _swiglu(bp, y):
    """The dense SwiGLU FFN's delta for the normed activations y."""
    return (F.silu(y @ bp["w_gate"]) * (y @ bp["w_up"])) @ bp["w_down"]


# ---------------------------------------------------------------------------
# training forward, loss and step
# ---------------------------------------------------------------------------


def _block_forward(bp, x, cfg: TransformerConfig):
    """One block over the whole sequence (causal, no pad, positions from 0).
    bp: {name: weight in the activation dtype}; x: [B, T, E].  Returns
    (x, aux): aux is the MoE load-balance loss in fp32, 0.0 when dense.
    The MoE FFN routes the B * T tokens in flat order under one capacity,
    dropping tokens past it (serving's FFN in models.generate drops none)."""
    b, t, e = x.shape
    q, k, v = _project_qkv(bp, _rms_norm(x, bp["ln1"]), cfg)
    q, k = _rope(q, k, torch.arange(t, device=x.device), cfg)
    attn = _ATTENTION[cfg.attn_impl](q, _gqa_repeat(k, cfg), _gqa_repeat(v, cfg), causal=True)
    x = x + attn.reshape(b, t, -1) @ bp["wo"]
    y = _rms_norm(x, bp["ln2"])
    if cfg.n_experts:
        r = moe_ffn(y.reshape(b * t, e), bp["router"], bp["w_in"], bp["w_out"],
                    capacity_factor=cfg.capacity_factor)
        return x + r.out.reshape(b, t, e), r.aux_loss.float()
    return x + _swiglu(bp, y), 0.0


def forward(model: TransformerLM, ids, return_aux: bool = False):
    """ids: [B, T] -> logits [B, T, V] in the activation dtype, and with
    return_aux the MoE load-balance loss summed over the layers (an fp32
    scalar, 0 when dense).  The single-device path of the JAX forward: each
    fp32 master is cast to cfg.dtype at its use, through autograd, so
    gradients reach the masters; attention is the dispatcher (the flash
    kernels on the card, or cfg.attn_impl's choice).  With cfg.remat each
    block's activations are recomputed in the backward instead of kept."""
    cfg = model.cfg
    dt = cfg.dtype
    x = model.embed.to(dt)[ids]
    aux = 0.0
    for blk in model.blocks:
        bp = {n: getattr(blk, n).to(dt) for n in model.block_keys}
        if cfg.remat and torch.is_grad_enabled():
            x, a = torch.utils.checkpoint.checkpoint(_block_forward, bp, x, cfg,
                                                     use_reentrant=False)
        else:
            x, a = _block_forward(bp, x, cfg)
        aux = aux + a
    x = _rms_norm(x, model.ln_f)
    logits = x @ model.lm_head.to(dt)
    if return_aux:
        return logits, torch.as_tensor(aux, dtype=torch.float32, device=logits.device)
    return logits


def cross_entropy_loss(logits, targets, mask=None):
    """Mean token negative log-likelihood in fp32; with a mask, the mean
    over the unmasked tokens (at least one in the denominator)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def make_loss_fn(cfg: TransformerConfig):
    """loss_fn(model, batch) with batch {"ids": [B, T + 1]}: next-token
    cross-entropy of forward(model, ids[:, :-1]) against ids[:, 1:], plus
    moe_aux_weight times the load-balance loss when n_experts > 0."""

    def loss_fn(model: TransformerLM, batch):
        ids = torch.as_tensor(batch["ids"], device=model.device).long()
        if not cfg.n_experts:
            return cross_entropy_loss(forward(model, ids[:, :-1]), ids[:, 1:])
        logits, aux = forward(model, ids[:, :-1], return_aux=True)
        return cross_entropy_loss(logits, ids[:, 1:]) + cfg.moe_aux_weight * aux

    return loss_fn


def make_train_step(
    cfg: TransformerConfig,
    mesh=None,
    optimizer: Optional[Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]] = None,
    learning_rate: float = 3e-4,
    device=None,
):
    """Returns (train_step, init_state), as the JAX package does.

    train_step(model, opt, batch) -> (model, opt, loss): one step of
    `optimizer` on the loss of make_loss_fn, the weights updated in place;
    loss is the detached fp32 scalar before the step.
    init_state(key=0) -> (model, opt): a TransformerLM from init_params with
    seed `key` on `device` (None means the card), or `key` itself when it
    is a TransformerLM (e.g. weights converted from the JAX package), and
    the optimizer built over its parameters.

    optimizer: a function of the parameters returning a torch optimizer.
    The default is optax.adamw(learning_rate, weight_decay=0.01) written as
    torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01):
    optax adds wd * p after the Adam scaling and torch decays p before it,
    which is the same update.  mesh: only None (one device) is ported."""
    if mesh is not None:
        raise NotImplementedError("sharded training (a mesh) is not ported yet: pass mesh=None")
    if optimizer is None:
        def optimizer(params):
            return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=0.01)
    loss_fn = make_loss_fn(cfg)

    def train_step(model: TransformerLM, opt: torch.optim.Optimizer, batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        opt.step()
        return model, opt, loss.detach()

    def init_state(key: Union[int, torch.Generator, TransformerLM] = 0):
        model = key if isinstance(key, TransformerLM) else init_params(cfg, key, device=device)
        return model, optimizer(model.parameters())

    return train_step, init_state

