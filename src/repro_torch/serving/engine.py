"""Batched serving engine: prefill + decode with a KV cache and sampling,
transcribed from the reference's ``serving/engine.py``.

``ServeEngine`` keeps aligned batch lanes (all lanes decode the same
position).  Prefill runs the single-token decode step over the prompt's
positions, as the reference's scan does, for every decoder family (KV
caches, Mamba2 and xLSTM states alike), so a request of ``S`` prompt
tokens and ``n`` new ones takes ``S + n - 1`` decode steps, each with
``2 L + 1`` RMSNorm launches (dense, vlm, moe, ssm) or ``2 L + 2 n_super
+ 1`` (hybrid).  The encoder family has no decode step and is rejected
with ``ValueError``, as in the reference.  The reference
donates its cache to each jitted step; the port allocates it once per
request and every step writes it in place.  Tokens stay on the device
until the request ends; the result carries the host wall time of its
prefill and decode parts (one synchronisation after prefill on the card
splits them).

The engine runs on the card unless ``device="cpu"`` is passed; without a
CUDA device ``device=None`` raises.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.backends.engine import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import (decode_step, init_cache,
                                      require_ported)


@dataclass
class GenerationResult:
    tokens: np.ndarray          # (B, prompt + generated)
    new_tokens: np.ndarray      # (B, generated)
    steps: int
    prefill_s: float = 0.0      # wall s of the prompt's decode steps
    decode_s: float = 0.0       # wall s of the generated tokens' steps


class ServeEngine:
    def __init__(self, cfg: ModelConfig, params, max_seq: int,
                 max_batch: int, *, device=None,
                 impl: Optional[str] = None):
        if cfg.family == "encoder":
            raise ValueError("encoder-only architectures have no decode "
                             "step")
        require_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params.to(self.device)
        self.max_seq = max_seq
        self.max_batch = max_batch
        self.impl = impl

    def decode(self, cache: Dict[str, torch.Tensor], tokens: torch.Tensor,
               pos: int) -> torch.Tensor:
        """One decode step of every lane: tokens ``(B, 1)`` at ``pos`` ->
        logits ``(B, 1, V)``; writes the cache in place."""
        logits, _ = decode_step(self.cfg, self.params, cache, tokens, pos,
                                impl=self.impl)
        return logits

    def prefill(self, prompts) -> Tuple[Dict[str, torch.Tensor],
                                        torch.Tensor]:
        """Run the decode step over the prompt ``(B, S)``: (the filled
        cache, the logits of the last position ``(B, 1, V)``)."""
        tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                 device=self.device)
        b, s = tokens.shape
        cache = init_cache(self.cfg, b, self.max_seq, self.device)
        logits = None
        for i in range(s):
            logits = self.decode(cache, tokens[:, i:i + 1], i)
        return cache, logits

    @torch.inference_mode()
    def generate(self, prompts: np.ndarray, max_new: int,
                 temperature: float = 0.0, seed: int = 0
                 ) -> GenerationResult:
        """prompts: (B, S) int, right-aligned equal-length batch."""
        b, s = prompts.shape
        if not (s >= 1 and max_new >= 1 and b <= self.max_batch
                and s + max_new <= self.max_seq):
            raise ValueError(f"{b} prompts of {s} tokens + {max_new} new do "
                             f"not fit max_batch={self.max_batch}, "
                             f"max_seq={self.max_seq}")
        t0 = time.perf_counter()
        cache, logits = self.prefill(prompts)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        cur = _sample(logits[:, -1], temperature, gen)
        out = [cur]
        for i in range(1, max_new):
            logits = self.decode(cache, cur[:, None], s + i - 1)
            cur = _sample(logits[:, -1], temperature, gen)
            out.append(cur)
        new = torch.stack(out, dim=1).cpu().numpy().astype(np.int32)
        return GenerationResult(
            tokens=np.concatenate([np.asarray(prompts, np.int32), new],
                                  axis=1),
            new_tokens=new, steps=max_new, prefill_s=t1 - t0,
            decode_s=time.perf_counter() - t1)


def _sample(logits: torch.Tensor, temperature: float,
            gen: torch.Generator) -> torch.Tensor:
    """Greedy (first maximum) at ``temperature <= 0``, else a categorical
    draw by the Gumbel-max trick with noise from ``gen``."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    u = torch.rand(logits.shape, generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return (logits.float() / temperature + gumbel).argmax(dim=-1)
