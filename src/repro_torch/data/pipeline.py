"""Deterministic synthetic token pipeline with host sharding + packing.

Production shape without external deps: an infinite, seeded, reproducible
stream of packed documents.  Every (step, host) pair maps to a unique
counter-based RNG stream, so restarts resume bit-identically from any
step (checkpoint stores only the step number) and each host materialises
only its shard — the properties a real 1000-node loader must have.

The port's copy of the reference's ``data/pipeline.py`` (numpy only): the
same config, step and host give the same bytes in both packages.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 1
    pad_id: int = 0
    mean_doc_len: int = 512
    family: str = "dense"   # "encoder" -> frame embeddings instead of ids
    d_model: int = 0        # for encoder frames


def _rng_for(cfg: DataConfig, step: int, host: int) -> np.random.Generator:
    key = f"{cfg.seed}:{step}:{host}".encode()
    digest = hashlib.blake2b(key, digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(digest, "little"))


def _pack_documents(rng: np.random.Generator, cfg: DataConfig,
                    rows: int) -> np.ndarray:
    """Pack variable-length 'documents' (zipf-ish token ids) into rows."""
    out = np.full((rows, cfg.seq_len), cfg.pad_id, np.int32)
    for r in range(rows):
        pos = 0
        while pos < cfg.seq_len:
            doc_len = int(np.clip(rng.exponential(cfg.mean_doc_len), 8,
                                  cfg.seq_len - pos))
            # zipf-like marginal over the vocab, cheap to sample
            toks = (rng.zipf(1.3, size=doc_len) + 1) % (cfg.vocab - 2) + 2
            out[r, pos: pos + doc_len] = toks
            pos += doc_len
            if pos < cfg.seq_len:
                out[r, pos] = cfg.eos_id
                pos += 1
    return out


def host_batch(cfg: DataConfig, step: int, host: int, n_hosts: int
               ) -> Dict[str, np.ndarray]:
    """This host's shard of the global batch for ``step`` (deterministic)."""
    if cfg.global_batch % n_hosts:
        raise ValueError("global_batch must divide by n_hosts")
    rows = cfg.global_batch // n_hosts
    rng = _rng_for(cfg, step, host)
    if cfg.family == "encoder":
        frames = rng.standard_normal(
            (rows, cfg.seq_len, cfg.d_model)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab, (rows, cfg.seq_len),
                              dtype=np.int32)
        return {"frames": frames, "labels": labels}
    tokens = _pack_documents(rng, cfg, rows)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = cfg.eos_id
    # don't train on pad positions
    labels = np.where(tokens == cfg.pad_id, -1, labels)
    return {"tokens": tokens, "labels": labels}


def global_batch(cfg: DataConfig, step: int, n_hosts: int = 1
                 ) -> Dict[str, np.ndarray]:
    """Assemble the full global batch (for tests and single-host callers)."""
    shards = [host_batch(cfg, step, h, n_hosts) for h in range(n_hosts)]
    return {k: np.concatenate([s[k] for s in shards], axis=0)
            for k in shards[0]}


def skewed_host_batch(cfg: DataConfig, step: int, host: int, n_hosts: int,
                      skew_host: int, extra_frac: float = 0.5
                      ) -> Dict[str, np.ndarray]:
    """A batch whose ``skew_host`` receives longer effective work (more
    non-pad tokens) — the data-skew straggler source for the power
    controller experiments."""
    b = host_batch(cfg, step, host, n_hosts)
    if host != skew_host or "tokens" not in b:
        return b
    t = b["tokens"]
    pad_mask = t == cfg.pad_id
    rng = _rng_for(cfg, step, host + 7919)
    fill = (rng.zipf(1.3, size=t.shape) + 1) % (cfg.vocab - 2) + 2
    keep_pad = rng.random(t.shape) > extra_frac
    b["tokens"] = np.where(pad_mask & ~keep_pad, fill.astype(np.int32), t)
    return b
