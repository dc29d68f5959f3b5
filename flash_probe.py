#!/usr/bin/env python3
"""How far the flash kernel moves full-width logits, on one GPU.

Full-width bf16 prefill logits of llama3-8b and zamba2-2.7b (random
weights from seed 0, S=4096, as ``chip_smoke.py`` builds them), normwise
against the plain path's, when only the flash attention differs: the
kernel path as routed, the kernel path with every flash launch on the
tensor-core kernel, and the plain path with the plain loop at kv tiles of
32 and 128 keys instead of 64.  The last two are the plain loop's own
rounding floor: the same arithmetic, summed in another order.  The
kernels' times are ``chip_smoke.py``'s.

Prints one JSON line per measurement and exits nonzero on a machine
without CUDA.  Run from the repository root:

    python3 flash_probe.py
"""

from __future__ import annotations

import functools
import gc
import json
import sys

import chip_smoke as cs


def logits_floor(torch, device, make):
    """Prefill logits of one full-width model under each flash variant,
    normwise against the plain path's."""
    import numpy as np

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch.steps import make_prefill_step

    cfg, params, _, _ = make(torch, device)
    tokens = np.random.default_rng(1).integers(2, cfg.vocab,
                                               (1, cs.PREFILL_SEQ))
    batch = {"tokens": tokens}
    cuda_fn, plain_fn = fa.flash_attention_cuda, fa.flash_attention_plain
    variants = {
        "kernel_path": ("cuda", {}),
        "kernel_path_all_tc": ("cuda", {"flash_attention_cuda":
                                        functools.partial(cuda_fn,
                                                          variant="tc")}),
        "plain_kv32": ("plain", {"flash_attention_plain":
                                 functools.partial(plain_fn, block_kv=32)}),
        "plain_kv128": ("plain", {"flash_attention_plain":
                                  functools.partial(plain_fn, block_kv=128)}),
    }
    with torch.inference_mode():
        ref = make_prefill_step(cfg, impl="plain")(params, batch)
        for name, (impl, swap) in variants.items():
            for attr, fn in swap.items():
                setattr(fa, attr, fn)
            try:
                step = make_prefill_step(cfg, impl=None if impl == "cuda"
                                         else "plain")
                got = step(params, batch)
            finally:
                fa.flash_attention_cuda = cuda_fn
                fa.flash_attention_plain = plain_fn
            print(json.dumps({
                "probe": "logits", "arch": cfg.arch_id, "variant": name,
                "rel_err_vs_plain": cs._rel_err(torch, got, ref),
                "argmax_agreement": float((got.argmax(-1) == ref.argmax(-1))
                                          .float().mean())}), flush=True)
            del got
    del params, ref
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(cs.SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    for make in (cs._llama_params, cs._zamba2_params):
        logits_floor(torch, device, make)
    return 0


if __name__ == "__main__":
    sys.exit(main())
