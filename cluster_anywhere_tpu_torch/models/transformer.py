"""The flagship decoder-only transformer (LLaMA-style) for the port: its
config, its weights as an nn.Module, the block helpers serving and
training share, the sharded forward, and the training step.

Counterpart of cluster_anywhere_tpu/models/transformer.py.  Weights keep
the JAX names and the JAX [in, out] layout (the code reads `y @ W`), and
are trainable fp32 masters as there.  `forward` casts each master to the
activation dtype at its use, through autograd, as the JAX forward does;
the serving path uses a copy cast once per weight update
(`TransformerLM.compute_weights`), which equals that cast because the
cast is deterministic.  With n_experts > 0 every block's FFN is a top-1
mixture of experts (parallel/moe.py).

On a mesh (parallel.make_mesh) every rank holds its shards of the
weights (param_specs: tp splits heads, ff and vocab, fsdp the other
matmul dim, ep the experts, pp the blocks by stage) and runs the region
JAX runs under shard_map: its pp stage's blocks through the pipeline
schedule, its sequence shard with ring or Ulysses attention (sp), its
rows of the batch (dp, fsdp, and ep for MoE).  Who reduces which
gradient is written out here (see `_Plan`), where JAX gets it from
GSPMD: every rank's loss is its share of the global mean; tp ranks and
pp stages compute the same loss as replicas (copy_to / reduce_from);
gradients of replicated weights are summed over the data axes after the
backward, an fsdp weight's by the reduce-scatter of its gather, an
expert's by the all_to_all's transpose.
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
from ..parallel.collectives import all_max, copy_to, gather_from, reduce_from, tensor_plane
from ..parallel.mesh import MeshSpec, axis_index, axis_size, mesh_device, mesh_spec
from ..parallel.moe import init_moe_params, moe_ffn
from ..parallel.pipeline import pipeline_apply
from ..parallel.ring_attention import ring_attention
from ..parallel.sharding import P, NamedSharding, full_tensor, local_shard, spec_axes
from ..parallel.ulysses import ulysses_attention

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
    """The JAX package's config, field for field, with its checks
    (layers_per_stage, resolved_attn).

    attn_impl: the training forward's attention.  "auto" and "dense" take
    the dispatcher (the flash kernels on the card), "flash" forces
    flash_attention (its plain version on the CPU), "jnp" the dense
    reference_attention; "ring" and "ulysses" are the sequence-parallel
    attentions when sp > 1 on a mesh ("auto" means ring there), and the
    dispatcher otherwise.  flash_block_q/k: accepted and ignored, since the
    Hopper kernels' tiles are fixed (ops/csrc/flash_sm90.cuh).  remat
    recomputes each block in the backward (torch.utils.checkpoint, the
    jax.checkpoint of the JAX forward).  unroll_layers has no effect:
    eager layers are never a rolled loop.  pp, sp and ep must match the
    mesh's dims where they are above 1."""

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
    attn_impl: str = "auto"  # auto | dense | flash | jnp | ring | ulysses
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
    ep: int = 1
    capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01

    def __post_init__(self):
        object.__setattr__(self, "dtype", as_torch_dtype(self.dtype))
        object.__setattr__(self, "param_dtype", as_torch_dtype(self.param_dtype))
        if self.attn_impl not in _ATTENTION:
            raise ValueError(f"unknown attn_impl {self.attn_impl!r}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"n_heads {self.n_heads} not a multiple of n_kv_heads {self.n_kv_heads}")

    @property
    def layers_per_stage(self) -> int:
        if self.n_layers % self.pp != 0:
            raise ValueError(f"n_layers {self.n_layers} not divisible by pp {self.pp}")
        return self.n_layers // self.pp

    def resolved_attn(self) -> str:
        if self.attn_impl != "auto":
            return self.attn_impl
        return "ring" if self.sp > 1 else "dense"


_ATTENTION = {
    "auto": attention,
    "dense": attention,
    "flash": flash_attention,
    "jnp": reference_attention,
    # without sequence parallelism (no mesh, or sp = 1) these are the
    # dispatcher, as in the JAX forward
    "ring": attention,
    "ulysses": attention,
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


# Placements as the JAX package's param_specs: tp shards head/ff/vocab dims,
# fsdp the other matmul dim, ep the experts; pp stacks the blocks by stage.
_TOP_SPECS = {"embed": P("fsdp", "tp"), "ln_f": P(None), "lm_head": P("fsdp", "tp")}
_BLOCK_SPECS = {
    "ln1": P(None),
    "wq": P("fsdp", "tp"),
    "wk": P("fsdp", "tp"),
    "wv": P("fsdp", "tp"),
    "wo": P("tp", "fsdp"),
    "ln2": P(None),
    # experts sharded over 'ep'; each expert's matmuls tp-sharded
    "router": P(None, None),
    "w_in": P("ep", "fsdp", "tp"),
    "w_out": P("ep", "tp", "fsdp"),
    "w_gate": P("fsdp", "tp"),
    "w_up": P("fsdp", "tp"),
    "w_down": P("tp", "fsdp"),
}


def param_specs(cfg: TransformerConfig) -> Dict[str, Any]:
    """PartitionSpecs of the JAX param tree (blocks stacked [L, ...], or
    [pp, L/pp, ...] with pp > 1), as the JAX package's param_specs."""
    lead = ("pp", None) if cfg.pp > 1 else (None,)
    return {
        **_TOP_SPECS,
        "blocks": {n: P(*lead, *_BLOCK_SPECS[n]) for n in block_shapes(cfg)},
    }


def _local_shape(shape, spec, mesh):
    out = list(shape)
    for dim, entry in enumerate(spec):
        n = 1
        for name in spec_axes(entry):
            n *= axis_size(mesh, name)
        if out[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split over {entry!r} ({n})")
        out[dim] //= n
    return tuple(out)


class TransformerBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, device: torch.device, mesh=None):
        super().__init__()
        for name, shape in block_shapes(cfg).items():
            shape = _local_shape(shape, _BLOCK_SPECS[name], mesh)
            self.register_parameter(
                name,
                nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype, device=device)),
            )


class TransformerLM(nn.Module):
    """Holds the weights: embed [V, E], blocks[i].{block_keys}, ln_f [E],
    lm_head [E, V]; block_keys are block_shapes(cfg)'s names.

    With a mesh, this rank's shards (param_specs) of its pp stage's
    blocks: blocks[i] is global block stage * layers_per_stage + i."""

    def __init__(self, cfg: TransformerConfig, device=None, mesh=None):
        super().__init__()
        if mesh is not None:
            _Plan(cfg, mesh)  # checks the config against the mesh
            dev = mesh_device(mesh)
        else:
            dev = resolve_device(device)
        self.cfg = cfg
        self.mesh = mesh
        pd = cfg.param_dtype

        def param(name, *shape):
            shape = _local_shape(shape, _TOP_SPECS[name], mesh)
            return nn.Parameter(torch.empty(shape, dtype=pd, device=dev))

        self.embed = param("embed", cfg.vocab_size, cfg.d_model)
        n_blocks = cfg.n_layers if mesh is None else cfg.layers_per_stage
        self.blocks = nn.ModuleList(TransformerBlock(cfg, dev, mesh) for _ in range(n_blocks))
        self.ln_f = param("ln_f", cfg.d_model)
        self.lm_head = param("lm_head", cfg.d_model, cfg.vocab_size)
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
        if self.mesh is not None:
            raise ValueError("serving takes an unsharded model (no mesh)")
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
                device=None, mesh=None) -> TransformerLM:
    """Random weights with the JAX package's scales (normal * fan_in^-0.5,
    embed * 0.02, norms 1; the MoE weights init_moe_params' scales), drawn
    from a seeded torch.Generator on the target device.  The numbers differ
    from jax.random's for the same seed; tests that need both packages on
    one set of weights convert the JAX params with
    models.convert.from_jax_params.

    With a mesh the whole model is drawn on this rank's device and the rank
    keeps its shards (shard_params), so one seed gives one model on every
    mesh, as the JAX package's init_state does."""
    if mesh is not None:
        return shard_params(init_params(cfg, generator, device=mesh_device(mesh)), mesh)
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


def shard_params(model: TransformerLM, mesh) -> TransformerLM:
    """A model holding this rank's shards of an unsharded `model` (every
    rank holding the same weights), by param_specs; its pp stage's blocks
    only.  A missing or 1-rank mesh returns `model` itself: nothing is
    sharded."""
    if mesh is None or mesh.size() <= 1:
        return model
    if model.mesh is not None:
        raise ValueError("the model is sharded already")
    cfg = model.cfg
    out = TransformerLM(cfg, mesh=mesh)
    first = axis_index(mesh, "pp") * cfg.layers_per_stage
    with torch.no_grad():
        for name in _TOP_SPECS:
            getattr(out, name).copy_(local_shard(getattr(model, name), _TOP_SPECS[name], mesh))
        for i, blk in enumerate(out.blocks):
            src = model.blocks[first + i]
            for name in out.block_keys:
                getattr(blk, name).copy_(local_shard(getattr(src, name), _BLOCK_SPECS[name], mesh))
    return out


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
        rep = cfg.n_heads // cfg.n_kv_heads
        x = x[:, :, :, None, :].expand(b, t, kv, rep, d).reshape(b, t, kv * rep, d)
    return x


def _swiglu(bp, y):
    """The dense SwiGLU FFN's delta for the normed activations y."""
    return (F.silu(y @ bp["w_gate"]) * (y @ bp["w_up"])) @ bp["w_down"]


# ---------------------------------------------------------------------------
# training forward, loss and step
# ---------------------------------------------------------------------------


def forward(model: TransformerLM, ids, mesh=None, return_aux: bool = False):
    """ids: [B, T] -> logits [B, T, V] in the activation dtype, and with
    return_aux the MoE load-balance loss summed over the layers (an fp32
    scalar, 0 when dense).  Each fp32 master is cast to cfg.dtype at its
    use, through autograd, so gradients reach the masters; attention is the
    dispatcher (the flash kernels on the card, or cfg.attn_impl's choice).
    With cfg.remat each block's activations are recomputed in the backward
    instead of kept.

    One forward serves both: a sharded model (built on a mesh; `mesh`, if
    given, must be its mesh) runs it on every rank, ids being the whole
    batch, the same on every rank, and every rank gets the whole logits
    (gathered; the gather's backward keeps this rank's slice); an
    unsharded model runs it with every mesh axis of size 1."""
    mesh = _active(mesh)
    if mesh is not None and mesh is not model.mesh:
        raise ValueError("forward on a mesh takes a model sharded on that mesh (init_params, "
                         "from_jax_params or shard_params with the mesh)")
    cfg = model.cfg
    if model.mesh is None and (cfg.pp > 1 or (cfg.n_experts and cfg.ep > 1) or (
            cfg.sp > 1 and cfg.resolved_attn() in ("ring", "ulysses"))):
        raise ValueError("mesh required for pp/sp/ep execution: build the model on a mesh")
    plan = _Plan(cfg, model.mesh)
    ids = torch.as_tensor(ids, device=model.device).long()
    logits, aux = _local_forward(model, plan.local_ids(ids), plan)
    logits = plan.gather_rows(gather_from(logits, model.mesh, "tp", axis=-1))
    if return_aux:
        return logits, torch.as_tensor(aux, dtype=torch.float32, device=logits.device)
    return logits


# ---------------------------------------------------------------------------
# the forward of one rank: the region JAX runs under shard_map (with no
# mesh every axis has size 1 and every collective is the identity)
# ---------------------------------------------------------------------------


def _active(mesh):
    """The mesh, or None for no mesh or a 1-rank one (nothing sharded)."""
    return None if mesh is None or mesh.size() <= 1 else mesh


class _Plan:
    """How a rank's share of the work is cut on a mesh, and who reduces
    which gradient.

    Data axes hold different tokens: dp and fsdp always, sp when it is
    manual (ring or Ulysses attention), ep for a MoE model (the batch is
    sharded over the experts' ranks, as JAX's shard_map does).  The other
    axes hold replicas of the same tokens: tp (sharded weights, the same
    activations), pp (every stage computes the loss from the outputs summed
    to it), and sp or ep where they are not manual.  A rank's loss is its
    tokens' share of the global mean; replicas each compute the same loss.

    Rows: the batch splits into ep groups (MoE), each group into
    num_microbatches microbatches (pp), each microbatch over the dp x fsdp
    ranks, dp major; a rank's rows are its part of every microbatch of its
    group, so its microbatch j is its part of JAX's microbatch j and the
    MoE routing group (JAX's manual-region tokens) spans dp and fsdp.

    With no mesh (one device) every axis has size 1: a rank's tokens are
    the whole batch."""

    def __init__(self, cfg: TransformerConfig, mesh):
        spec = mesh_spec(mesh) if mesh is not None else MeshSpec()
        if cfg.pp != spec.pp:
            raise ValueError(f"cfg.pp={cfg.pp} disagrees with the mesh's pp axis ({spec.pp})")
        cfg.layers_per_stage  # n_layers % pp
        if cfg.n_experts:
            if cfg.ep > 1 and cfg.ep != spec.ep:
                raise ValueError(f"cfg.ep={cfg.ep} disagrees with the mesh's ep axis ({spec.ep})")
            if cfg.n_experts % spec.ep != 0:
                raise ValueError(f"n_experts={cfg.n_experts} not divisible by the mesh's ep axis "
                                 f"({spec.ep})")
        if cfg.n_heads % spec.tp or cfg.n_kv_heads % spec.tp:
            raise ValueError(f"n_heads {cfg.n_heads} and n_kv_heads {cfg.n_kv_heads} must split "
                             f"over tp={spec.tp}")
        self.cfg, self.mesh, self.spec = cfg, mesh, spec
        self.sp_manual = cfg.sp > 1 and cfg.resolved_attn() in ("ring", "ulysses")
        self.moe = bool(cfg.n_experts)
        self.data_axes = ("dp", "fsdp") + (("sp",) if self.sp_manual else ()) + (
            ("ep",) if self.moe else ())
        self.n_data = 1
        for a in self.data_axes:
            self.n_data *= axis_size(mesh, a)
        self.micro = cfg.num_microbatches if cfg.pp > 1 else 1

    def _row_split(self, b):
        groups = self.spec.ep if self.moe else 1
        g = self.spec.dp * self.spec.fsdp
        if b % (groups * self.micro * g):
            raise ValueError(f"batch {b} does not split into {groups} expert groups x "
                             f"{self.micro} microbatches x {g} dp*fsdp ranks")
        return groups, g, b // (groups * self.micro * g)

    def local_ids(self, ids):
        """This rank's rows and sequence shard of the global ids [B, T]."""
        if self.mesh is None:
            return ids
        groups, g, r = self._row_split(ids.shape[0])
        rows = torch.arange(ids.shape[0], device=ids.device).reshape(groups, self.micro, g, r)
        me = axis_index(self.mesh, "dp") * self.spec.fsdp + axis_index(self.mesh, "fsdp")
        rows = rows[axis_index(self.mesh, "ep") if self.moe else 0, :, me].reshape(-1)
        ids = ids.index_select(0, rows)
        if self.sp_manual:
            t = ids.shape[1]
            if t % self.spec.sp:
                raise ValueError(f"sequence {t} does not split over sp={self.spec.sp}")
            c = t // self.spec.sp
            ids = ids[:, axis_index(self.mesh, "sp") * c:][:, :c]
        return ids

    def gather_rows(self, x):
        """The inverse of local_ids for [rows, T_local, ...]: the global
        tensor, every rank's part in place (the backward keeps this rank's)."""
        mesh = self.mesh
        if mesh is None:
            return x
        if self.sp_manual:
            x = gather_from(x, mesh, "sp", axis=1)
        x = x.reshape(self.micro, -1, *x.shape[1:])
        x = gather_from(gather_from(x, mesh, "fsdp", axis=1), mesh, "dp", axis=1)
        x = x.reshape(-1, *x.shape[2:])
        return gather_from(x, mesh, "ep", axis=0) if self.moe else x

    def grad_axes(self, name: str, spec) -> Tuple[str, ...]:
        """The axes a weight's local gradient is summed over after the
        backward: the data axes, less fsdp for a weight sharded over it (the
        reduce-scatter of its gather summed it) and ep for an expert (the
        all_to_all's transpose brought every rank's tokens); plus pp for
        embed, which only stage 0's microbatches use."""
        sharded = {a for e in spec for a in spec_axes(e)}
        axes = tuple(a for a in self.data_axes if not (a in ("fsdp", "ep") and a in sharded))
        return axes + (("pp",) if name == "embed" else ())


def _gathered(w, spec, mesh, dt):
    """A weight cast to dt and gathered over fsdp at its use (the gather's
    backward reduce-scatters the gradient over the fsdp ranks)."""
    w = w.to(dt)
    if mesh is None:
        return w
    for dim, entry in enumerate(spec):
        if "fsdp" in spec_axes(entry):
            w = tensor_plane.allgather(w, mesh, "fsdp", axis=dim)
    return w


def _block_forward(bp, x, cfg: TransformerConfig, plan: _Plan):
    """One block on this rank's rows and sequence shard: heads and ff
    sharded over tp (copy_to at the entry of each sharded matmul pair,
    reduce_from at its exit), attention ring or Ulysses over sp when
    manual, the MoE FFN over ep.  bp: this block's weights, cast and
    fsdp-gathered.  Returns (x, aux): aux is the MoE load-balance loss in
    fp32, 0.0 when dense."""
    mesh = plan.mesh
    b, t, e = x.shape
    d = cfg.d_head
    y = copy_to(_rms_norm(x, bp["ln1"]), mesh, "tp")
    q = (y @ bp["wq"]).reshape(b, t, -1, d)
    k = (y @ bp["wk"]).reshape(b, t, -1, d)
    v = (y @ bp["wv"]).reshape(b, t, -1, d)
    positions = torch.arange(t, device=x.device)
    if plan.sp_manual:
        positions = positions + axis_index(mesh, "sp") * t
    q, k = _rope(q, k, positions, cfg)
    k, v = _gqa_repeat(k, cfg), _gqa_repeat(v, cfg)
    impl = cfg.resolved_attn()
    if plan.sp_manual and impl == "ring":
        attn = ring_attention(q, k, v, mesh, axis_name="sp", causal=True)
    elif plan.sp_manual:
        attn = ulysses_attention(q, k, v, mesh, axis_name="sp", causal=True)
    else:
        attn = _ATTENTION[cfg.attn_impl](q, k, v, causal=True)
    x = x + reduce_from(attn.reshape(b, t, -1) @ bp["wo"], mesh, "tp")
    y = _rms_norm(x, bp["ln2"])
    if cfg.n_experts:
        r = moe_ffn(y.reshape(b * t, e), bp["router"], bp["w_in"], bp["w_out"],
                    capacity_factor=cfg.capacity_factor, mesh=mesh, axis_name="ep",
                    token_axes=("dp", "fsdp"), ffn_axis="tp")
        return x + r.out.reshape(b, t, e), r.aux_loss.float()
    y = copy_to(y, mesh, "tp")
    delta = reduce_from(_swiglu(bp, y), mesh, "tp")
    return x + delta, 0.0


def _stage_forward(bps, x, cfg: TransformerConfig, plan: _Plan):
    """This rank's blocks (its pp stage) in turn.  Returns (x, aux summed)."""
    aux = 0.0
    for bp in bps:
        if cfg.remat and torch.is_grad_enabled():
            x, a = torch.utils.checkpoint.checkpoint(_block_forward, bp, x, cfg, plan,
                                                     use_reentrant=False)
        else:
            x, a = _block_forward(bp, x, cfg, plan)
        aux = aux + a
    return x, aux


def _local_forward(model: TransformerLM, ids, plan: _Plan):
    """This rank's vocab shard of the logits of its ids, [rows, T_local,
    V / tp], and the aux loss (pmean'd over ep and sp, summed over stages,
    as JAX's; 0.0 when dense)."""
    cfg, mesh = model.cfg, plan.mesh
    dt = cfg.dtype
    if axis_index(mesh, "pp") == 0:
        w = gather_from(_gathered(model.embed, _TOP_SPECS["embed"], mesh, dt), mesh, "tp", axis=1)
        x = w[ids]
    else:  # only stage 0 reads the pipeline's input
        x = torch.zeros(*ids.shape, cfg.d_model, dtype=dt, device=ids.device)
    bps = [{n: _gathered(getattr(blk, n), _BLOCK_SPECS[n], mesh, dt) for n in model.block_keys}
           for blk in model.blocks]

    def stage(params, a):
        return _stage_forward(params, a, cfg, plan)

    if cfg.pp > 1:
        if plan.moe:
            x, aux = pipeline_apply(stage, bps, x, mesh, num_microbatches=cfg.num_microbatches,
                                    with_aux=True)
        else:
            x = pipeline_apply(lambda p, a: stage(p, a)[0], bps, x, mesh,
                               num_microbatches=cfg.num_microbatches)
            aux = 0.0
    else:
        x, aux = stage(bps, x)
    if plan.moe:
        # the aux of each shard is over its own tokens: mean it over the
        # manual data axes (pp summed it inside the pipeline)
        for name in ("ep",) + ("sp",) * plan.sp_manual:
            aux = tensor_plane.allreduce(aux, mesh, name) / axis_size(mesh, name)
    x = _rms_norm(x, model.ln_f)
    logits = copy_to(x, mesh, "tp") @ _gathered(model.lm_head, _TOP_SPECS["lm_head"], mesh, dt)
    return logits, aux


def _vocab_parallel_nll(logits, targets, mesh):
    """Per-token negative log-likelihood in fp32 from this rank's vocab
    shard of the logits (tp splits the vocab), without gathering them: the
    row max, the sum of exponentials and the gold logit are reduced over
    tp (reduce_from: every tp rank goes on with the same values)."""
    logits = logits.float()
    v_local = logits.shape[-1]
    m = all_max(logits.amax(dim=-1), mesh, "tp").detach()
    sumexp = reduce_from(torch.exp(logits - m[..., None]).sum(dim=-1), mesh, "tp")
    local = targets - axis_index(mesh, "tp") * v_local
    mine = (local >= 0) & (local < v_local)
    gold = logits.gather(-1, local.clamp(0, v_local - 1)[..., None])[..., 0]
    gold = reduce_from(torch.where(mine, gold, torch.zeros_like(gold)), mesh, "tp")
    return m + torch.log(sumexp) - gold


def _global_ids(ids, cfg: TransformerConfig, mesh, device):
    """The whole batch's ids from a tensor (the same on every rank) or from
    a DTensor placed by make_batch_sharding."""
    from torch.distributed.tensor import DTensor

    if isinstance(ids, DTensor):
        want = make_batch_sharding(cfg, mesh)
        if tuple(ids.placements) != want.placements:
            raise TypeError(f"batch placements {ids.placements} are not "
                            f"make_batch_sharding's {want.placements}")
        ids = full_tensor(ids.to_local(), want.spec, mesh)
    return torch.as_tensor(ids, device=device).long()


def sync_grads(model: TransformerLM) -> None:
    """Sum each local gradient over the axes _Plan.grad_axes names, one
    flat buffer per set of axes (a missing gradient counts as zeros: embed
    off stage 0)."""
    if model.mesh is None:
        return
    plan = _Plan(model.cfg, model.mesh)
    buckets: Dict[Tuple[str, ...], list] = {}
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        spec = _TOP_SPECS.get(leaf) or _BLOCK_SPECS[leaf]
        axes = tuple(a for a in plan.grad_axes(leaf, spec) if axis_size(model.mesh, a) > 1)
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        if axes:
            buckets.setdefault(axes, []).append(p)
    with torch.no_grad():
        for axes, params in buckets.items():
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            for a in axes:
                flat = tensor_plane.allreduce(flat, model.mesh, a)
            start = 0
            for p in params:
                p.grad.copy_(flat[start:start + p.numel()].view_as(p))
                start += p.numel()


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


def make_loss_fn(cfg: TransformerConfig, mesh=None):
    """loss_fn(model, batch) with batch {"ids": [B, T + 1]}: next-token
    cross-entropy of forward(model, ids[:, :-1]) against ids[:, 1:], plus
    moe_aux_weight times the load-balance loss when n_experts > 0.

    On a mesh every rank passes the whole batch (or a DTensor placed by
    make_batch_sharding) and gets the global loss; its backward gives the
    rank's share of the gradient, which sync_grads completes."""
    mesh = _active(mesh)

    def loss_fn(model: TransformerLM, batch):
        if mesh is None:
            ids = torch.as_tensor(batch["ids"], device=model.device).long()
            if not cfg.n_experts:
                return cross_entropy_loss(forward(model, ids[:, :-1]), ids[:, 1:])
            logits, aux = forward(model, ids[:, :-1], return_aux=True)
            return cross_entropy_loss(logits, ids[:, 1:]) + cfg.moe_aux_weight * aux
        if model.mesh is not mesh:
            raise ValueError("the model is not sharded on this loss function's mesh")
        plan = _Plan(cfg, mesh)
        ids = _global_ids(batch["ids"], cfg, mesh, model.device)
        n_tokens = ids.shape[0] * (ids.shape[1] - 1)
        inputs, targets = plan.local_ids(ids[:, :-1]), plan.local_ids(ids[:, 1:])
        logits, aux = _local_forward(model, inputs, plan)
        loss = _vocab_parallel_nll(logits, targets, mesh).sum() / n_tokens
        if cfg.n_experts:
            loss = loss + cfg.moe_aux_weight * aux / plan.n_data
        for name in plan.data_axes:
            loss = reduce_from(loss, mesh, name)
        return loss

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
    seed `key` (on `device`, None meaning the card, or on the mesh's
    device), or `key` itself when it is a TransformerLM (e.g. weights
    converted from the JAX package), and the optimizer built over its
    parameters.

    mesh: a DeviceMesh from parallel.make_mesh over every rank of the
    process group; every rank calls train_step with the same batch, and
    the optimizer steps this rank's shards on gradients summed by
    sync_grads.  None (or a 1-rank mesh) is one device.

    optimizer: a function of the parameters returning a torch optimizer.
    The default is optax.adamw(learning_rate, weight_decay=0.01) written as
    torch.optim.AdamW(lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01):
    optax adds wd * p after the Adam scaling and torch decays p before it,
    which is the same update."""
    if mesh is not None:
        import torch.distributed as dist

        world = dist.get_world_size() if dist.is_initialized() else 1
        if mesh.size() != world:
            raise ValueError(f"the mesh has {mesh.size()} ranks and the process group "
                             f"{world}: a mesh spans every rank")
        device = mesh_device(mesh)
        mesh = _active(mesh)
        if mesh is not None:
            _Plan(cfg, mesh)
    if optimizer is None:
        def optimizer(params):
            return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=0.01)
    loss_fn = make_loss_fn(cfg, mesh)

    def train_step(model: TransformerLM, opt: torch.optim.Optimizer, batch):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, batch)
        loss.backward()
        sync_grads(model)
        opt.step()
        return model, opt, loss.detach()

    def init_state(key: Union[int, torch.Generator, TransformerLM] = 0):
        if isinstance(key, TransformerLM):
            model = key
            if model.mesh is not mesh:
                raise ValueError("the model is not sharded on the train step's mesh")
        else:
            model = init_params(cfg, key, device=device, mesh=mesh)
        return model, optimizer(model.parameters())

    return train_step, init_state


def make_batch_sharding(cfg: TransformerConfig, mesh) -> NamedSharding:
    """Input batch placement: batch over (dp, fsdp), sequence over sp."""
    return NamedSharding(mesh, P(("dp", "fsdp"), "sp" if cfg.sp > 1 else None))
