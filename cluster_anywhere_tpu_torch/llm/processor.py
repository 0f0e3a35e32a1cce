"""The LLM inference worker and its configuration (counterpart of
cluster_anywhere_tpu/llm/processor.py): tokenize, left-pad to a fixed
prompt length, generate on the card, detokenize.

The Data-library pipeline (`Processor`, `build_llm_processor`) is not
ported yet (ROADMAP Queue 1 item 2b).  The config fields only it reads
(batch_size, concurrency, apply_chat_template, system_prompt) are accepted
and inert until then, as they are on the JAX package's serving path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np
import torch


class ByteTokenizer:
    """Offline byte-level tokenizer (ids: 0=pad, 1=bos, 2=eos, byte b -> b+3).
    Any object with encode/decode can be plugged into ProcessorConfig.tokenizer."""

    vocab_size = 259
    pad_id, bos_id, eos_id = 0, 1, 2

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = [b + 3 for b in text.encode("utf-8")]
        return ([self.bos_id] + ids) if add_bos else ids

    def decode(self, ids) -> str:
        out = bytearray()
        for i in ids:
            i = int(i)
            if i >= 3:
                out.append(i - 3)
        return out.decode("utf-8", "replace")


PRESETS = {
    "tiny": dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, d_head=16, d_ff=128),
    "small": dict(d_model=256, n_layers=4, n_heads=8, n_kv_heads=8, d_head=32, d_ff=512),
}


@dataclass
class ModelSpec:
    """Which transformer weights to run.  Presets init random weights from
    `seed` (torch's generator: other numbers than the JAX package's for the
    same seed); `params_path` loads a checkpoint in the shared npz format.
    config_overrides may name the dtype as a string ("float32")."""

    preset: str = "tiny"  # tiny | small | custom
    params_path: Optional[str] = None
    seed: int = 0
    config_overrides: Dict[str, Any] = field(default_factory=dict)

    def transformer_config(self, vocab_size: int):
        from ..models.transformer import TransformerConfig

        base = dict(PRESETS.get(self.preset, PRESETS["tiny"]))
        base.update(self.config_overrides)
        return TransformerConfig(vocab_size=vocab_size, **base)


@dataclass
class ProcessorConfig:
    model: ModelSpec = field(default_factory=ModelSpec)
    tokenizer: Any = None  # defaults to ByteTokenizer
    # read by the Data library's Processor (not ported yet); inert when serving
    batch_size: int = 8
    concurrency: int = 1
    max_prompt_len: int = 64
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    apply_chat_template: bool = False  # Processor only, as batch_size
    system_prompt: str = ""  # Processor only, as batch_size
    # prefix/KV-cache reuse in ContinuousLLMServer: requests sharing a
    # system-prompt prefix skip its prefill (0 entries disables)
    prefix_cache_entries: int = 8
    prefix_block: int = 16


def load_model(cfg: ProcessorConfig, tcfg, device):
    """The TransformerLM a ProcessorConfig names: its checkpoint, or random
    weights from its seed."""
    from ..models.convert import from_jax_params
    from ..models.transformer import init_params

    if cfg.model.params_path:
        from ._params_io import load_params

        return from_jax_params(load_params(cfg.model.params_path), tcfg, device)
    return init_params(tcfg, cfg.model.seed, device)


class _InferenceWorker:
    """Holds the model for its lifetime and serves batches of prompts."""

    def __init__(self, cfg: ProcessorConfig, device=None):
        from .._device import resolve_device

        self.cfg = cfg
        self.device = resolve_device(device)
        self.tok = cfg.tokenizer or ByteTokenizer()
        self.tcfg = cfg.model.transformer_config(self.tok.vocab_size)
        self.params = load_model(cfg, self.tcfg, self.device)
        self._step = 0

    def _generator(self) -> torch.Generator:
        """A fresh seeded generator per call, seeded where the JAX package
        builds its key (seed * 1000003 + call count)."""
        self._step += 1
        return torch.Generator(device=self.device).manual_seed(
            self.cfg.model.seed * 1000003 + self._step
        )

    def __call__(
        self,
        batch: Dict[str, np.ndarray],
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
    ) -> Dict[str, np.ndarray]:
        from ..models.generate import generate

        cfg = self.cfg
        prompts = [str(p) for p in batch["prompt"].tolist()]
        encoded = [self.tok.encode(p)[: cfg.max_prompt_len] for p in prompts]
        # left-pad to the fixed max_prompt_len, as the JAX package does
        max_len = cfg.max_prompt_len
        ids = np.full((len(encoded), max_len), self.tok.pad_id, np.int64)
        lens = np.empty(len(encoded), np.int64)
        for i, e in enumerate(encoded):
            ids[i, max_len - len(e):] = e
            lens[i] = len(e)
        out = generate(
            self.params,
            torch.from_numpy(ids),
            self._generator(),
            cfg=self.tcfg,
            max_new_tokens=cfg.max_new_tokens if max_new_tokens is None else max_new_tokens,
            temperature=cfg.temperature if temperature is None else temperature,
            top_k=cfg.top_k if top_k is None else top_k,
            top_p=cfg.top_p if top_p is None else top_p,
            prompt_lens=torch.from_numpy(lens),
        ).cpu().numpy()
        result = dict(batch)
        result["generated_tokens"] = out
        result["generated_text"] = np.asarray([self.tok.decode(row) for row in out], dtype=object)
        return result

    def stream(
        self,
        prompt: str,
        max_new_tokens: Optional[int] = None,
        temperature: Optional[float] = None,
        top_k: Optional[int] = None,
        top_p: Optional[float] = None,
    ):
        """Token-by-token decoding of one prompt: yields {"token_id", "text"}
        per sampled token."""
        from ..models.generate import stream_generate

        cfg = self.cfg
        encoded = self.tok.encode(prompt)[: cfg.max_prompt_len]
        ids = np.full((1, cfg.max_prompt_len), self.tok.pad_id, np.int64)
        ids[0, cfg.max_prompt_len - len(encoded):] = encoded
        for tok in stream_generate(
            self.params,
            torch.from_numpy(ids),
            self._generator(),
            cfg=self.tcfg,
            max_new_tokens=cfg.max_new_tokens if max_new_tokens is None else max_new_tokens,
            temperature=cfg.temperature if temperature is None else temperature,
            top_k=cfg.top_k if top_k is None else top_k,
            top_p=cfg.top_p if top_p is None else top_p,
            prompt_lens=torch.tensor([len(encoded)]),
        ):
            tid = int(tok[0])
            yield {"token_id": tid, "text": self.tok.decode([tid])}
