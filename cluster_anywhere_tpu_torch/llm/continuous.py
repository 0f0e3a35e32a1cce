"""Continuous batching for LLM decoding: the iteration-level scheduler
(counterpart of cluster_anywhere_tpu/llm/continuous.py).

The scheduler owns a fixed pool of decode SLOTS over one shared KV cache
[L, S, T_max, KV, D] on the card.  Each slot runs one request; requests at
different depths decode together in one step with per-row positions:

- admit: a queued request prefills (batch 1, prompt left-padded to a bucket
  length) and its cache rows are copied into its slot between steps.
- decode: every live slot advances one token per step.  Finished or empty
  slots still compute (their lanes are garbage) but write only to their own
  frozen cache rows, which the next admit overwrites; their attention gets
  an empty column range, so it reads none of their K/V.
- finish: a slot frees the moment its request hits max_new_tokens or eos;
  the next step() can admit into it.

Where the JAX package donates the cache to a jitted step, this port updates
it in place.  The prefix cache therefore stores and hands out clones: the
suffix steps write into the rows they are given, and a later hit must read
the rows as the prefix prefill left them.
"""

from __future__ import annotations

import hashlib
import itertools
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.generate import (
    _block_decode_rowpos,
    _gumbel_argmax,
    _nucleus_mask,
    _sample,
    decode_one,
    prefill,
)
from ..models.transformer import TransformerConfig, TransformerLM, _rms_norm
from ..ops.attention import NEG_INF


@dataclass
class Request:
    request_id: int
    prompt_ids: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    eos_id: Optional[int] = None
    # filled as the request runs
    out_tokens: List[int] = field(default_factory=list)
    slot: int = -1
    done: bool = False


def _sample_rowwise(logits, generator, temps, top_ks, top_ps):
    """Per-row sampling: temps, top_ks, top_ps are [S] tensors (each request
    carries its own knobs).  top_k <= 0 means no truncation; top_p outside
    (0, 1) means no nucleus mask; temp <= 0 means greedy."""
    greedy = logits.argmax(dim=-1).to(torch.int32)
    scaled = logits / temps.clamp_min(1e-6)[:, None]
    v = logits.shape[-1]
    sorted_desc = scaled.sort(dim=-1, descending=True).values
    kth = sorted_desc.gather(-1, (top_ks.long() - 1).clamp(0, v - 1)[:, None])
    drop = (top_ks[:, None] > 0) & (scaled < kth)
    scaled = torch.where(drop, torch.full_like(scaled, NEG_INF), scaled)
    scaled = _nucleus_mask(scaled, top_ps[:, None])
    return torch.where(temps <= 0.0, greedy, _gumbel_argmax(scaled, generator))


def _decode_step_rowpos(params: TransformerLM, cache, tokens, pos, pads, temps, top_ks, top_ps,
                        generator, *, cfg: TransformerConfig):
    """One token for every slot, each at its own cache position.  All of
    tokens/pos/pads/temps/top_ks/top_ps are [S] device tensors.  Returns
    (next_tokens [S] int32, cache updated in place)."""
    w = params.compute_weights()
    x = w["embed"][tokens][:, None, :]
    for i, bp in enumerate(w["blocks"]):
        x = _block_decode_rowpos(bp, x, (cache["k"][i], cache["v"][i]), pos, cfg, pads)
    x = _rms_norm(x, w["ln_f"])
    logits = (x[:, 0] @ w["lm_head"]).float()
    return _sample_rowwise(logits, generator, temps, top_ks, top_ps), cache


def _install_slot(cache, slot_k, slot_v, slot: int):
    """Copy one request's prefilled rows [L, T_max, KV, D] into its slot."""
    cache["k"][:, slot] = slot_k
    cache["v"][:, slot] = slot_v
    return cache


def _suffix_step(params: TransformerLM, rows, token, pos: int, pad, *, cfg: TransformerConfig):
    """One teacher-forced token over a single request's cache rows
    ([L, 1, T_max, KV, D], updated in place): feeds a known prompt token at
    column `pos` and returns its next-token logits [1, V].  Hit and miss
    both run the suffix through this, so their tokens are identical."""
    return decode_one(params, rows, token, pos, cfg, pad)


class PrefixCache:
    """Bounded LRU of prefilled prompt-prefix KV rows, keyed by the prefix
    token content and bucket.  A hit skips the prefix prefill."""

    def __init__(self, entries: int):
        self.entries = entries
        self._d: "OrderedDict[str, dict]" = OrderedDict()
        self.evictions = 0

    @staticmethod
    def key(prefix_ids: np.ndarray, bucket: int) -> str:
        h = hashlib.sha1(np.ascontiguousarray(prefix_ids, np.int32).tobytes())
        return f"{h.hexdigest()}:{len(prefix_ids)}:{bucket}"

    def get(self, key: str):
        e = self._d.get(key)
        if e is not None:
            self._d.move_to_end(key)
        return e

    def put(self, key: str, rows: dict, pad: int) -> None:
        self._d[key] = {"rows": rows, "pad": pad}
        while len(self._d) > self.entries:
            self._d.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._d)

    def memory_bytes(self) -> int:
        return sum(a.numel() * a.element_size() for e in self._d.values() for a in e["rows"].values())


class ContinuousBatcher:
    """Iteration-level scheduler over a fixed slot pool (see module doc).

    Drive it with submit() + step() (one decode iteration), or pump() until
    every request finishes.  step() returns the tokens each request produced
    in that iteration, so tokens can stream per request."""

    def __init__(
        self,
        params: TransformerLM,
        cfg: TransformerConfig,
        *,
        slots: int = 8,
        t_max: int = 512,
        prefill_buckets: tuple = (64, 128, 256),
        top_k: int = 0,
        prefix_cache_entries: int = 0,
        prefix_block: int = 16,
    ):
        self.params = params
        self.cfg = cfg
        self.device = params.device
        self.slots = slots
        self.t_max = t_max
        self.top_k = top_k
        self.prefill_buckets = tuple(sorted(prefill_buckets))
        # prefix/KV reuse (0 entries = off).  When on, admit splits the
        # prompt at a block multiple: the prefix prefills once and its rows
        # are cached; the suffix is teacher-forced on hit and miss alike.
        self.prefix_cache = PrefixCache(prefix_cache_entries) if prefix_cache_entries > 0 else None
        self.prefix_block = max(1, int(prefix_block))
        # split granularity, as in the JAX package: max(block, longest
        # bucket / 8), rounded up to a block multiple
        longest = self.prefill_buckets[-1] if self.prefill_buckets else t_max
        q = max(self.prefix_block, longest // 8)
        self._split_quantum = -(-q // self.prefix_block) * self.prefix_block
        shape = (cfg.n_layers, slots, t_max, cfg.n_kv_heads, cfg.d_head)
        self.cache = {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=self.device),
        }
        self._tokens = np.zeros(slots, np.int64)
        self._pos = np.zeros(slots, np.int64)  # cache column of the NEXT write
        self._pads = np.zeros(slots, np.int64)
        self._temps = np.zeros(slots, np.float32)
        self._topks = np.zeros(slots, np.int64)
        self._topps = np.ones(slots, np.float32)
        self._by_slot: List[Optional[Request]] = [None] * slots
        self.queue: deque[Request] = deque()
        self._completed: deque[Request] = deque(maxlen=4096)
        self._ids = itertools.count(1)
        # seeded where the JAX batcher takes jax.random.key(0)
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        self.stats = {
            "admitted": 0, "finished": 0, "decode_steps": 0, "cancelled": 0,
            "prefix_hits": 0, "prefix_misses": 0, "prefix_tokens_reused": 0,
        }

    # ------------------------------------------------------------- interface
    def submit(
        self,
        prompt_ids,
        *,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: Optional[int] = None,
        top_p: float = 1.0,
        eos_id: Optional[int] = None,
    ) -> Request:
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if len(prompt) + max_new_tokens > self.t_max:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens ({max_new_tokens}) "
                f"exceeds the cache length {self.t_max}"
            )
        req = Request(
            next(self._ids), prompt, int(max_new_tokens), float(temperature),
            self.top_k if top_k is None else int(top_k), float(top_p), eos_id,
        )
        self.queue.append(req)
        return req

    def cancel(self, request_id: int) -> bool:
        """Abort one request: drop it from the queue, or free its slot.
        Returns False when the request already finished."""
        for i, r in enumerate(self.queue):
            if r.request_id == request_id:
                del self.queue[i]
                r.done = True
                self.stats["cancelled"] += 1
                return True
        for s, r in enumerate(self._by_slot):
            if r is not None and r.request_id == request_id:
                r.done = True
                self._by_slot[s] = None  # lane decodes garbage; rows frozen
                self.stats["cancelled"] += 1
                return True
        return False

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self._by_slot)

    @torch.no_grad()
    def step(self) -> Dict[int, List[int]]:
        """Admit into free slots, then decode one token on every live slot.
        Returns {request_id: [new tokens this step]}, including the first
        token of requests admitted this step."""
        out: Dict[int, List[int]] = {}
        self._admit(out)
        live = [s for s, r in enumerate(self._by_slot) if r is not None]
        if not live:
            return out

        def dev(a):
            return torch.from_numpy(a).to(self.device)

        nxt, self.cache = _decode_step_rowpos(
            self.params, self.cache, dev(self._tokens), dev(self._pos), dev(self._step_pads()),
            dev(self._temps), dev(self._topks), dev(self._topps), self._gen, cfg=self.cfg,
        )
        nxt = nxt.cpu().numpy()
        self.stats["decode_steps"] += 1
        for s in live:
            req = self._by_slot[s]
            tok = int(nxt[s])
            req.out_tokens.append(tok)
            out.setdefault(req.request_id, []).append(tok)
            self._tokens[s] = tok
            self._pos[s] += 1
            if len(req.out_tokens) >= req.max_new_tokens or (
                req.eos_id is not None and tok == req.eos_id
            ):
                self._finish(s, req)
        return out

    def pump(self) -> List[Request]:
        """Run until every submitted request finishes; returns them in
        completion order."""
        before = {id(r) for r in self._completed}
        while self.has_work:
            self.step()
        return [r for r in self._completed if id(r) not in before]

    # ------------------------------------------------------------- internals
    def _step_pads(self) -> np.ndarray:
        """The pads a decode step attends from: a live slot's own, and for a
        free slot pos + 1, an empty range [pos + 1, pos + 1), so that its
        garbage lane reads no K/V."""
        free = np.fromiter((r is None for r in self._by_slot), bool, self.slots)
        return np.where(free, self._pos + 1, self._pads)

    def _finish(self, slot: int, req: Request) -> None:
        req.done = True
        self._by_slot[slot] = None
        self._completed.append(req)
        self.stats["finished"] += 1

    def _bucket(self, n: int, max_new: int) -> int:
        """Smallest bucket holding the prompt and leaving room to decode;
        the exact prompt length when every bucket would overflow."""
        for b in self.prefill_buckets:
            if n <= b and b + max_new <= self.t_max:
                return b
        return n

    def _prefix_split(self, prompt: np.ndarray) -> int:
        """Cacheable prefix length: the largest _split_quantum multiple that
        leaves >= 1 suffix token; 0 when the prompt is too short."""
        split = ((len(prompt) - 1) // self._split_quantum) * self._split_quantum
        return split if split >= self.prefix_block else 0

    def _prefill_padded(self, ids: np.ndarray, bucket: int):
        padded = np.zeros((1, bucket), np.int64)
        pad = bucket - len(ids)
        padded[0, pad:] = ids  # LEFT pad: the prefill contract
        logits, cache = prefill(
            self.params, torch.from_numpy(padded).to(self.device), self.cfg, self.t_max,
            pad=torch.tensor([pad], device=self.device),
        )
        return logits, cache, pad

    def _admit_full_prefill(self, req: Request):
        """Cold admit: prefill the whole prompt.  Returns (first-token logits
        [1, V], slot rows, pad, next_pos)."""
        bucket = self._bucket(len(req.prompt_ids), req.max_new_tokens)
        logits, cache, pad = self._prefill_padded(req.prompt_ids, bucket)
        return logits, {"k": cache["k"][:, 0], "v": cache["v"][:, 0]}, pad, bucket

    def _admit_prefix_cached(self, req: Request, split: int):
        """Admit through the prefix cache: the prefix rows come from the cache
        (or prefill once and populate it); the suffix is teacher-forced
        through _suffix_step token by token on hit and miss alike."""
        prompt = req.prompt_ids
        suffix = prompt[split:]
        bucket = self._bucket(split, req.max_new_tokens + len(suffix))
        key = PrefixCache.key(prompt[:split], bucket)
        entry = self.prefix_cache.get(key)
        if entry is None:
            _, cache, pad = self._prefill_padded(prompt[:split], bucket)
            rows = {"k": cache["k"][:, 0:1], "v": cache["v"][:, 0:1]}
            # the cache keeps its own copy: the suffix steps write into rows
            self.prefix_cache.put(key, {k: v.clone() for k, v in rows.items()}, pad)
            self.stats["prefix_misses"] += 1
        else:
            pad = entry["pad"]
            rows = {k: v.clone() for k, v in entry["rows"].items()}
            self.stats["prefix_hits"] += 1
            self.stats["prefix_tokens_reused"] += split
        pad_t = torch.tensor([pad], device=self.device)
        logits = None
        for i, tok in enumerate(suffix):
            logits, rows = _suffix_step(
                self.params, rows, torch.tensor([int(tok)], device=self.device),
                bucket + i, pad_t, cfg=self.cfg,
            )
        return logits, {"k": rows["k"][:, 0], "v": rows["v"][:, 0]}, pad, bucket + len(suffix)

    def _admit(self, out: Optional[Dict[int, List[int]]] = None) -> None:
        while self.queue and None in self._by_slot:
            req = self.queue.popleft()
            slot = self._by_slot.index(None)
            split = self._prefix_split(req.prompt_ids) if self.prefix_cache is not None else 0
            if split:
                logits, rows, pad, next_pos = self._admit_prefix_cached(req, split)
            else:
                logits, rows, pad, next_pos = self._admit_full_prefill(req)
            self.cache = _install_slot(self.cache, rows["k"], rows["v"], slot)
            first = int(_sample(logits, self._gen, req.temperature, req.top_k, req.top_p)[0])
            req.out_tokens.append(first)
            if out is not None:
                out.setdefault(req.request_id, []).append(first)
            req.slot = slot
            self._by_slot[slot] = req
            self._tokens[slot] = first
            self._pos[slot] = next_pos  # next write lands after the prompt
            self._pads[slot] = pad
            self._temps[slot] = req.temperature
            self._topks[slot] = req.top_k
            self._topps[slot] = req.top_p
            self.stats["admitted"] += 1
            if len(req.out_tokens) >= req.max_new_tokens or (
                req.eos_id is not None and first == req.eos_id
            ):
                self._finish(slot, req)
