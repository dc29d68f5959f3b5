"""Serving CLI of the port, LLM mode: batched prefill + decode of a dense
or hybrid model with random weights from a seed, through
:class:`ServeEngine`::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b --full
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-2.7b --full

It runs on the card by default and fails without one; ``--device cpu``
runs it on the CPU (``--smoke``, the default, is the reduced config).
The reference's sweep-service mode comes with the port's service.
"""

from __future__ import annotations

import argparse
import sys
import time


def _serve_llm(args: argparse.Namespace) -> int:
    import numpy as np
    import torch

    from repro_torch.backends.engine import resolve_device
    from repro_torch.configs import get_config, get_smoke
    from repro_torch.models import init_params
    from repro_torch.serving.engine import ServeEngine

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    params = init_params(cfg, gen)
    engine = ServeEngine(cfg, params,
                         max_seq=args.prompt_len + args.max_new,
                         max_batch=args.batch, device=device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    t0 = time.perf_counter()
    result = engine.generate(prompts, args.max_new,
                             temperature=args.temperature)
    dt = time.perf_counter() - t0
    tps = args.batch * args.max_new / dt
    print(f"[serve] {args.arch} on {device}: batch={args.batch} "
          f"prompt={args.prompt_len} new={args.max_new} "
          f"-> {dt:.2f}s ({tps:.1f} tok/s incl. prefill)")
    for b in range(min(args.batch, 2)):
        print(f"  lane {b}: ...{result.tokens[b, -8:].tolist()}")
    return 0


def main(argv=None) -> int:
    from repro_torch.configs import ARCH_IDS, ENCODER_ARCHS

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=[a for a in ARCH_IDS
                                       if a not in ENCODER_ARCHS],
                    default="qwen1.5-4b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises "
                         "without CUDA)")
    return _serve_llm(ap.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
