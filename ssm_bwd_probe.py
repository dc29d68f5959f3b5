#!/usr/bin/env python3
"""Where the tensor-core ssm_scan backward spends its time, on one GPU.

At zamba2-2.7b's training shape (``chip_smoke.SSM_MAIN``, bf16, inputs
as ``chip_smoke.py`` draws them) in a fresh process: the kernel against
its bf16-operand twin (the largest 64-step tile's normwise distance, as
``chip_smoke.py`` holds it), both kernels' times by CUDA events (the
scan kernel forced at bf16), and the device time of each of the
tensor-core kernel's three kernels by ``torch.profiler`` (the mean over
``REPS`` calls); the tensor-core kernel's time and kernels also with dy
rounded to bf16 (``*_bf16_dy``), as the model's path gives it.
``chip_smoke.py`` reads the same kernel late in a process of ~10^6
launches, where profiler sessions lose records.

Prints one JSON line with the card's name and power limit and exits
nonzero on a machine without CUDA.  Run from the repository root:

    python3 ssm_bwd_probe.py
"""

from __future__ import annotations

import json
import subprocess
import sys

import chip_smoke as cs

REPS = 20


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ssm_bwd_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import ssm_scan as ss

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=device).manual_seed(13)
    b, h, s, p, n = cs.SSM_MAIN
    rnd = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                     device=device)
    args = (rnd(b, h, s, p).bfloat16(), -rnd(b, h, s).abs() * 0.2,
            rnd(b, h, s).abs(), rnd(b, s, n).bfloat16(),
            rnd(b, s, n).bfloat16(), rnd(b, h, s, p))
    got = ss.ssm_scan_bwd(*args, chunk=cs.SSM_CHUNK)
    twin = ss.ssm_scan_bwd_chunked_plain(*args, operands="bf16")
    tiles = {g: cs._step_tiles(torch, a, w, axis) for g, a, w, axis in
             zip(cs.SSM_GRADS, got, twin, cs.SSM_STEP_AXES)}
    model = args[:5] + (args[5].to(torch.bfloat16).float(),)
    times = cs._event_times(torch, {
        "tc_ms": lambda: ss.ssm_scan_bwd(*args, chunk=cs.SSM_CHUNK),
        "tc_bf16_dy_ms": lambda: ss.ssm_scan_bwd(*model, chunk=cs.SSM_CHUNK),
        "scan_ms": lambda: ss.ssm_scan_bwd(*args, chunk=cs.SSM_CHUNK,
                                           variant="scan")}, reps=REPS)
    device_ms = {}
    for tag, inputs in (("device_ms", args), ("device_ms_bf16_dy", model)):
        with cs.profiler_session(torch) as prof:
            for _ in range(REPS):
                ss.ssm_scan_bwd(*inputs, chunk=cs.SSM_CHUNK)
            torch.cuda.synchronize()
        kernels = device_ms.setdefault(tag, {})
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = next((k for k in ("ssm_tc_states", "ssm_tc_chunk",
                                         "ssm_tc_sum") if k in e.key), e.key)
                kernels[name] = kernels.get(name, 0.0) + \
                    cs._self_device_us(e) / 1e3 / REPS
    print(json.dumps({"probe": "ssm_bwd", "nvidia_smi": smi,
                      "shape": list(cs.SSM_MAIN), "reps": REPS,
                      "tile_normwise": tiles, **times, **device_ms}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
