"""Training CLI of the port: real training with the power-aware runtime.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
        --steps 20 --hosts 8

``--smoke`` (the default) uses the architecture's reduced config;
``--full`` the published one, with ``--n-layers`` / ``--d-model`` to cut
it.  It runs on the card unless ``--device cpu`` is given, and fails
without one.  Prints per-step loss and the modelled power-aware vs
equal-share makespans (the paper's metric, closed-loop), and last each
kernel's launch count.  The flags are the reference's (``python -m
repro.launch.train``) plus ``--device``.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace

from repro_torch.configs import ARCH_IDS, get_config, get_smoke
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.trainer import (DEFAULT_CKPT_DIR, PowerAwareTrainer,
                                         TrainerConfig)


def build_trainer(arch: str, smoke: bool, steps: int, hosts: int,
                  batch: int, seq: int, ckpt_dir: str,
                  power_aware: bool = True,
                  fail_at: tuple = (),
                  d_model: int = 0, n_layers: int = 0,
                  seed: int = 0, device=None,
                  model=None) -> PowerAwareTrainer:
    """The reference's ``build_trainer`` on the port: ``device`` (None =
    the card, raising without one; ``"cpu"``) and an optional ``model``
    to start from (see :class:`PowerAwareTrainer`)."""
    mcfg = get_smoke(arch) if smoke else get_config(arch)
    if d_model or n_layers:
        mcfg = replace(mcfg,
                       d_model=d_model or mcfg.d_model,
                       n_layers=n_layers or mcfg.n_layers)
    dcfg = DataConfig(vocab=mcfg.vocab, seq_len=seq, global_batch=batch,
                      seed=seed, family="encoder"
                      if mcfg.family == "encoder" else "dense",
                      d_model=mcfg.d_model)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=max(steps // 10, 5),
                       total_steps=steps)
    tcfg = TrainerConfig(steps=steps, ckpt_every=max(steps // 5, 5),
                         ckpt_dir=ckpt_dir, n_hosts=hosts,
                         power_aware=power_aware, fail_at_steps=fail_at,
                         seed=seed)
    return PowerAwareTrainer(mcfg, dcfg, ocfg, tcfg, device=device,
                             model=model)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCH_IDS, default="llama3-8b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--hosts", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=0,
                    help="override width (e.g. scale smoke up to ~100M)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--no-power-aware", dest="power_aware",
                    action="store_false", default=True)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default=None,
                    help="'cpu', or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    trainer = build_trainer(args.arch, args.smoke, args.steps, args.hosts,
                            args.batch, args.seq, args.ckpt_dir,
                            power_aware=args.power_aware,
                            fail_at=tuple(args.fail_at),
                            d_model=args.d_model, n_layers=args.n_layers,
                            device=args.device)
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"[train] {args.arch} ({'smoke' if args.smoke else 'full'}) "
          f"params={n_params/1e6:.1f}M hosts={args.hosts} "
          f"P={trainer.P:.0f}W power_aware={args.power_aware} "
          f"device={trainer.device}")
    history = trainer.run()
    if not history:
        print(f"[train] nothing to do: the checkpoint is at step "
              f"{trainer.start_step - 1}")
        return 0
    for r in history:
        if r.step % max(len(history) // 10, 1) == 0 or \
                r.step == history[-1].step:
            print(f"  step {r.step:4d} loss {r.loss:8.4f} "
                  f"makespan aware {r.makespan_power_aware:6.3f}s "
                  f"equal {r.makespan_equal_share:6.3f}s "
                  f"straggler h{r.straggler}")
    s = trainer.speedup_summary()
    print(f"[train] hosts left {trainer.n_hosts}; last step "
          f"{history[-1].step}")
    print(f"[train] loss {s['first_loss']:.4f} -> {s['final_loss']:.4f}; "
          f"power-aware speedup over equal-share: {s['speedup']:.3f}x")
    print(f"[train] kernel launches {json.dumps(kernel_launches())}")
    return 0


def kernel_launches() -> dict:
    """Every kernel's launch count in this process (0 on the CPU, where
    only the plain versions run)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn
    from repro_torch.kernels import ssm_scan as ss

    return dict(sorted({**rn.LAUNCHES, **fa.LAUNCHES,
                        **ss.LAUNCHES}.items()))


if __name__ == "__main__":
    sys.exit(main())
