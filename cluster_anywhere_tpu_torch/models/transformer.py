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
(`make_train_step`); pipeline/sequence/expert parallelism, remat and MoE
are later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from .._device import resolve_device
from ..ops.attention import attention

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def as_torch_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    """A torch dtype from a torch dtype or its name ("bfloat16", "float32")."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = str(dtype).rsplit(".", 1)[-1]
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
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
    n_experts: int = 0  # MoE serving is not ported: > 0 raises

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_torch_dtype(self.dtype))
        object.__setattr__(self, "param_dtype", as_torch_dtype(self.param_dtype))
        if self.n_experts:
            raise NotImplementedError("MoE serving (n_experts > 0) is not ported yet")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} not a multiple of n_kv_heads {self.n_kv_heads}")


_BLOCK_SHAPES = {
    "ln1": lambda c: (c.d_model,),
    "wq": lambda c: (c.d_model, c.n_heads * c.d_head),
    "wk": lambda c: (c.d_model, c.n_kv_heads * c.d_head),
    "wv": lambda c: (c.d_model, c.n_kv_heads * c.d_head),
    "wo": lambda c: (c.n_heads * c.d_head, c.d_model),
    "ln2": lambda c: (c.d_model,),
    "w_gate": lambda c: (c.d_model, c.d_ff),
    "w_up": lambda c: (c.d_model, c.d_ff),
    "w_down": lambda c: (c.d_ff, c.d_model),
}
BLOCK_KEYS = tuple(_BLOCK_SHAPES)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device):
        super().__init__()
        for name, shape in _BLOCK_SHAPES.items():
            self.register_parameter(
                name,
                nn.Parameter(torch.empty(shape(cfg), dtype=cfg.param_dtype, device=device)),
            )


class TransformerLM(nn.Module):
    """Holds the weights: embed [V, E], blocks[i].{ln1, wq, wk, wv, wo, ln2,
    w_gate, w_up, w_down}, ln_f [E], lm_head [E, V]."""

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
                    {n: getattr(blk, n).detach().to(dt) for n in BLOCK_KEYS} for blk in self.blocks
                ],
                "ln_f": self.ln_f.detach().to(dt),
                "lm_head": self.lm_head.detach().to(dt),
            }
        return self._compute


def init_params(cfg: TransformerConfig, generator: Union[int, torch.Generator] = 0,
                device=None) -> TransformerLM:
    """Random weights with the JAX package's scales (normal * fan_in^-0.5,
    embed * 0.02, norms 1), drawn from a seeded torch.Generator on the
    target device.  The numbers differ from jax.random's for the same seed;
    tests that need both packages on one set of weights convert the JAX
    params with models.convert.from_jax_params."""
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
            for name in BLOCK_KEYS:
                p = getattr(blk, name)
                if name.startswith("ln"):
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


def _mlp(bp, x, cfg: TransformerConfig):
    """Dense SwiGLU FFN with its residual."""
    y = _rms_norm(x, bp["ln2"])
    gated = F.silu(y @ bp["w_gate"]) * (y @ bp["w_up"])
    return x + gated @ bp["w_down"]


# ---------------------------------------------------------------------------
# training forward, loss and step
# ---------------------------------------------------------------------------


def _block_forward(bp, x, cfg: TransformerConfig):
    """One block over the whole sequence (causal, no pad, positions from 0).
    bp: {name: weight in the activation dtype}; x: [B, T, E]."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(bp, _rms_norm(x, bp["ln1"]), cfg)
    q, k = _rope(q, k, torch.arange(t, device=x.device), cfg)
    attn = attention(q, _gqa_repeat(k, cfg), _gqa_repeat(v, cfg), causal=True)
    x = x + attn.reshape(b, t, -1) @ bp["wo"]
    return _mlp(bp, x, cfg)


def forward(model: TransformerLM, ids):
    """ids: [B, T] -> logits [B, T, V] in the activation dtype.  The dense
    single-device path of the JAX forward: each fp32 master is cast to
    cfg.dtype at its use, through autograd, so gradients reach the masters;
    attention is the dispatcher (the flash kernels on the card)."""
    cfg = model.cfg
    dt = cfg.dtype
    x = model.embed.to(dt)[ids]
    for blk in model.blocks:
        x = _block_forward({n: getattr(blk, n).to(dt) for n in BLOCK_KEYS}, x, cfg)
    x = _rms_norm(x, model.ln_f)
    return x @ model.lm_head.to(dt)


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
    cross-entropy of forward(model, ids[:, :-1]) against ids[:, 1:]."""
    if cfg.n_experts:
        raise NotImplementedError("MoE training (n_experts > 0) is not ported yet")

    def loss_fn(model: TransformerLM, batch):
        ids = torch.as_tensor(batch["ids"], device=model.device).long()
        return cross_entropy_loss(forward(model, ids[:, :-1]), ids[:, 1:])

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

