"""Attention for the port: the flash-attention forward (csrc/flash_fwd.cu)
and backward (csrc/flash_bwd.cu: the dQ and the dK/dV kernels) as CUDA
kernels, their plain PyTorch versions, the dense reference, and the
dispatcher the model calls.

Counterpart of cluster_anywhere_tpu/ops/attention.py.  Layout contract as
there: q is [B, T, H, D], k and v are [B, T_kv, H, D] (GQA callers repeat
the K/V heads first), accumulation is fp32 whatever the input dtype, and
the optional `pad` is a [B] count of left-pad keys to drop per batch row.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version, which computes what the kernel computes.
When an input requires grad, `flash_attention` (and `attention`) go
through `_FlashAttentionFn`, the counterpart of the JAX package's
`custom_vjp`s: its backward is `flash_attention_bwd`, the two backward
wrappers.  `merge_attention` is not ported yet.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

NEG_INF = -1e30
KERNEL_D_HEADS = (16, 32, 64, 128)
_KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def reference_attention(q, k, v, causal: bool = True, scale: Optional[float] = None, pad=None):
    """Dense attention (CPU path and test oracle): [B,T,H,D] -> [B,T,H,D].
    pad: optional [B] left-pad counts (keys < pad[b] masked).  A fully
    masked row softmaxes over -1e30 everywhere, i.e. uniformly, as the JAX
    reference does."""
    d = q.shape[-1]
    if scale is None:
        scale = d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    t_q, t_k = s.shape[-2], s.shape[-1]
    mask = None
    if causal:
        mask = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device).tril()[None, None]
    if pad is not None:
        key_ok = (torch.arange(t_k, device=q.device)[None, :] >= pad[:, None])[:, None, None, :]
        mask = key_ok if mask is None else (mask & key_ok)
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _masked_scores(q, k, *, causal: bool, scale: float, pad=None):
    """scale * Q K^T in fp32, [B, H, T, T_kv], with masked scores at -1e30:
    causal is top-left aligned (q_pos >= k_pos from 0) also when T != T_kv,
    and keys below pad[b] are dropped."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    t_q, t_k = s.shape[-2], s.shape[-1]
    ok = torch.ones(t_q, t_k, dtype=torch.bool, device=q.device)
    if causal:
        ok = ok.tril()
    ok = ok[None, None]
    if pad is not None:
        key_ok = torch.arange(t_k, device=q.device)[None, :] >= pad.to(q.device)[:, None]
        ok = ok & key_ok[:, None, None, :]
    return torch.where(ok, s, torch.full_like(s, NEG_INF))


def _flash_attention_plain(q, k, v, *, causal: bool, scale: float, pad=None):
    """Plain PyTorch version of the forward kernel, in fp32 whatever the
    input dtype.  Returns (O [B,T,H,D] in q's dtype, LSE [B,H,T] fp32).
    Masked probabilities are zero, so a fully masked row gives O = 0 and
    LSE = -1e30."""
    s = _masked_scores(q, k, causal=causal, scale=scale, pad=pad)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(s <= NEG_INF, torch.zeros_like(p), p)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l_safe.permute(0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def _bwd_delta(o, do, dlse=None):
    """delta = rowsum(dO * O) - dLSE, [B, H, T] fp32: the term both backward
    kernels subtract from dP.  An LSE cotangent folds in with the opposite
    sign, since dLSE/ds = P per row (JAX: _flash_with_lse_bwd)."""
    delta = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1)
    if dlse is not None:
        delta = delta - dlse.float()
    return delta.contiguous()


def _flash_bwd_plain(q, k, v, o, lse, do, *, causal: bool, scale: float, pad=None, dlse=None):
    """Plain PyTorch version of the two backward kernels (the FA2 formulas
    of the JAX package's _bwd_dq_kernel and _bwd_dkv_kernel), in fp32
    whatever the input dtype: P = exp(s - lse) with P zeroed at
    s <= -1e30, dP = dO V^T, dS = P (dP - delta), dQ = scale dS K,
    dK = scale dS^T Q, dV = P^T dO.  Returns (dQ, dK, dV) in the inputs'
    dtypes.  The reference the kernels are held to; on the CPU the
    wrappers run its two halves, from delta."""
    return _bwd_plain_from_delta(q, k, v, do, lse, _bwd_delta(o, do, dlse), causal=causal,
                                 scale=scale, pad=pad)


def _bwd_plain_from_delta(q, k, v, do, lse, delta, *, causal: bool, scale: float, pad=None):
    """_flash_bwd_plain given delta [B, H, T] in place of O and dLSE: what
    the two kernels take."""
    s = _masked_scores(q, k, causal=causal, scale=scale, pad=pad)
    p = torch.exp(s - lse[..., None])
    p = torch.where(s <= NEG_INF, torch.zeros_like(p), p)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.float()) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def check_kernel_inputs(q, k, v, pad=None) -> None:
    """Raise ValueError on what the CUDA kernel does not take: q [B,T,H,D],
    k and v [B,T_kv,H,D] of q's dtype (bf16 or fp32), D in KERNEL_D_HEADS,
    pad a [B] integer tensor."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants [B,T,H,D] tensors, got {q.shape}, {k.shape}, {v.shape}")
    b, _, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not match q {tuple(q.shape)}")
    if d not in KERNEL_D_HEADS:
        raise ValueError(f"flash kernel takes d_head in {KERNEL_D_HEADS}, got {d}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash kernel takes bf16 or fp32 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if pad is not None and (pad.shape != (b,) or pad.dtype.is_floating_point):
        raise ValueError(f"pad must be a [B] integer tensor, got {tuple(pad.shape)} {pad.dtype}")


def _kernel_layout(x):
    """x itself when the kernel can read it through its strides (unit stride
    on d_head, 16-byte-aligned rows), else a contiguous copy."""
    align = 16 // x.element_size()
    if (
        x.stride(3) == 1
        and all(s % align == 0 for s in x.stride()[:3])
        and x.data_ptr() % 16 == 0
    ):
        return x
    return x.contiguous()


_FLASH_ARGTYPES = (
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 6
    + [ctypes.c_longlong] * 12
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


@functools.lru_cache(maxsize=None)
def _flash_fwd_entry():
    """The kernel's C entry point (built at first use), its ctypes
    signature set once: every pointer and the stream as c_void_p, which
    ctypes would otherwise cut to 32 bits."""
    from ._build import load

    fn = load("flash_fwd").flash_fwd
    fn.argtypes = _FLASH_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _flash_fwd_cuda(q, k, v, *, causal: bool, scale: float, pad=None):
    check_kernel_inputs(q, k, v, pad)
    dev = q.device
    if k.device != dev or v.device != dev or (pad is not None and pad.device != dev):
        raise ValueError("flash_attention: q, k, v and pad must be on one device")
    q, k, v = _kernel_layout(q), _kernel_layout(k), _kernel_layout(v)
    b, t, h, d = q.shape
    t_kv = k.shape[1]
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, lse
    pad_i32 = None if pad is None else pad.to(torch.int32).contiguous()
    fn = _flash_fwd_entry()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if pad_i32 is None else pad_i32.data_ptr(),
            out.data_ptr(), lse.data_ptr(),
            b, t, t_kv, h, d, int(q.dtype == torch.bfloat16),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            out.stride(0), out.stride(1), out.stride(2),
            float(scale), int(bool(causal)), stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError_t {err}")
    flash_attention.launches += 1
    return out, lse


def _flash_forward(q, k, v, *, causal: bool, scale: float, pad=None):
    """(O, LSE): the forward kernel on a CUDA tensor, its plain version on
    a CPU tensor."""
    if q.device.type == "cuda":
        return _flash_fwd_cuda(q, k, v, causal=causal, scale=scale, pad=pad)
    if q.device.type == "cpu":
        return _flash_attention_plain(q, k, v, causal=causal, scale=scale, pad=pad)
    raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")


# ------------------------------------------------------------------ backward

_BWD_INPUT_ARGTYPES = [ctypes.c_void_p] * 7  # q, k, v, dO, lse, delta, pad
_BWD_TAIL_ARGTYPES = (
    [ctypes.c_int] * 6  # B, T, T_kv, H, D, is_bf16
    + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)


@functools.lru_cache(maxsize=None)
def _flash_bwd_entries():
    """The backward kernels' C entry points (flash_bwd_dq, flash_bwd_dkv),
    built at first use, their ctypes signatures set once."""
    from ._build import load

    lib = load("flash_bwd")
    dq, dkv = lib.flash_bwd_dq, lib.flash_bwd_dkv
    dq.argtypes = _BWD_INPUT_ARGTYPES + [ctypes.c_void_p] + _BWD_TAIL_ARGTYPES
    dkv.argtypes = _BWD_INPUT_ARGTYPES + [ctypes.c_void_p] * 2 + _BWD_TAIL_ARGTYPES
    dq.restype = dkv.restype = ctypes.c_int
    return dq, dkv


def _bwd_kernel_args(q, k, v, do, lse, delta, pad):
    """Checks what the backward kernels take and returns their inputs in a
    layout they read: (q, k, v, dO, lse, delta, pad as int32 or None, the
    12 input strides as a ctypes array).  Raises ValueError otherwise."""
    check_kernel_inputs(q, k, v, pad)
    b, t, h, _ = q.shape
    if q.device.type != "cuda":
        raise ValueError(f"the backward kernels run on CUDA tensors, not {q.device}")
    if do.shape != q.shape or do.dtype != q.dtype:
        raise ValueError(f"dO {tuple(do.shape)} {do.dtype} does not match q {tuple(q.shape)} {q.dtype}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b, h, t) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be a [B, H, T] fp32 tensor, got {tuple(x.shape)} {x.dtype}")
    dev = q.device
    if any(x is not None and x.device != dev for x in (k, v, do, lse, delta, pad)):
        raise ValueError("flash_attention backward: every input must be on one device")
    q, k, v, do = (_kernel_layout(x) for x in (q, k, v, do))
    strides = (ctypes.c_longlong * 12)(
        *(s for x in (q, k, v, do) for s in x.stride()[:3])
    )
    pad_i32 = None if pad is None else pad.to(torch.int32).contiguous()
    return q, k, v, do, lse.contiguous(), delta.contiguous(), pad_i32, strides


def _bwd_launch(fn, name, q, k, v, do, lse, delta, pad_i32, strides, outs, causal, scale):
    b, t, h, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), None if pad_i32 is None else pad_i32.data_ptr(),
            *(o.data_ptr() for o in outs),
            b, t, k.shape[1], h, d, int(q.dtype == torch.bfloat16),
            strides, float(scale), int(bool(causal)), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float, pad=None):
    """dQ [B, T, H, D] in q's dtype, given the forward's LSE and
    delta = rowsum(dO * O) - dLSE, both [B, H, T] fp32.  A CUDA tensor
    launches the dQ kernel (csrc/flash_bwd.cu, counterpart of
    _bwd_dq_kernel) and counts it in `flash_bwd_dq.launches`, or raises on
    what the kernel does not take; a CPU tensor runs the plain version."""
    if q.device.type == "cpu":
        return _bwd_plain_from_delta(q, k, v, do, lse, delta, causal=causal, scale=scale,
                                     pad=pad)[0]
    args = _bwd_kernel_args(q, k, v, do, lse, delta, pad)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    _bwd_launch(_flash_bwd_entries()[0], "flash_bwd_dq", *args, (dq,), causal, scale)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float, pad=None):
    """(dK, dV) [B, T_kv, H, D] in k's dtype; inputs as for flash_bwd_dq.
    A CUDA tensor launches the dK/dV kernel (csrc/flash_bwd.cu, counterpart
    of _bwd_dkv_kernel) and counts it in `flash_bwd_dkv.launches`; a CPU
    tensor runs the plain version."""
    if q.device.type == "cpu":
        return _bwd_plain_from_delta(q, k, v, do, lse, delta, causal=causal, scale=scale,
                                     pad=pad)[1:]
    args = _bwd_kernel_args(q, k, v, do, lse, delta, pad)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    _bwd_launch(_flash_bwd_entries()[1], "flash_bwd_dkv", *args, (dk, dv), causal, scale)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool, scale: float, pad=None, dlse=None):
    """(dQ, dK, dV) of flash attention from the forward's O and LSE and the
    cotangents dO (and dLSE, when the caller differentiates through LSE):
    delta by a torch reduction, then `flash_bwd_dq` and `flash_bwd_dkv`
    (the kernels on CUDA tensors, their plain versions on CPU tensors)."""
    delta = _bwd_delta(o, do, dlse)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale, pad=pad)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale, pad=pad)
    return dq, dk, dv


class _FlashAttentionFn(torch.autograd.Function):
    """(O, LSE) = flash attention, differentiable in q, k, v, with the
    cotangents of both outputs (JAX: _flash and _flash_with_lse and their
    custom_vjp's).  Saves q, k, v, O, LSE and pad; pad gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, pad, causal, scale):
        out, lse = _flash_forward(q, k, v, causal=causal, scale=scale, pad=pad)
        ctx.save_for_backward(q, k, v, out, lse, pad)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse, pad = ctx.saved_tensors
        if do is None:  # only LSE was used
            do = torch.zeros_like(out)
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, causal=ctx.causal,
                                         scale=ctx.scale, pad=pad, dlse=dlse)
        return dq, dk, dv, None, None, None


def _needs_grad(*xs) -> bool:
    return torch.is_grad_enabled() and any(x.requires_grad for x in xs)


def flash_attention(q, k, v, *, causal: bool = True, scale: Optional[float] = None, pad=None,
                    return_lse: bool = False):
    """Flash attention.  q: [B, T, H, D]; k, v: [B, T_kv, H, D].

    pad: optional [B] per-row LEFT-pad counts; keys at positions < pad[b]
    are masked (the left-padded prompt mask of the LLM prefill).  With
    return_lse=True also returns the per-row log-sum-exp [B, H, T] in fp32.

    A CUDA tensor launches csrc/flash_fwd.cu (and counts the launch in
    `flash_attention.launches`), or raises on a shape or dtype the kernel
    does not take; a CPU tensor runs the plain PyTorch version.  When an
    input requires grad the call goes through `_FlashAttentionFn`, whose
    backward launches the two kernels of csrc/flash_bwd.cu; otherwise
    nothing is saved."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _needs_grad(q, k, v):
        out, lse = _FlashAttentionFn.apply(q, k, v, pad, causal, scale)
    else:
        out, lse = _flash_forward(q, k, v, causal=causal, scale=scale, pad=pad)
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def attention(q, k, v, causal: bool = True, scale: Optional[float] = None, pad=None):
    """Dispatcher: the flash kernels for every shape on the card; on the CPU
    the dense reference (as the JAX dispatcher does there), or, when an
    input requires grad, flash attention's plain forward and backward."""
    if q.device.type == "cuda" or _needs_grad(q, k, v):
        return flash_attention(q, k, v, causal=causal, scale=scale, pad=pad)
    return reference_attention(q, k, v, causal=causal, scale=scale, pad=pad)
