#!/usr/bin/env python3
"""Design variants of the ``ssm_scan`` kernel, timed side by side on one GPU.

Each variant is ``src/repro_torch/kernels/csrc/ssm_scan.cu`` with one
design choice undone or moved, built into a library of its own (one
``nvcc`` each, all started together):

* ``shipped``: the source as it is;
* ``butterfly``: the tree's three cross-thread stages once a step (3
  shuffles a row and step) in place of the reduce-scatter over four steps;
* ``steps16`` / ``steps64``: tiles of 16 steps, or of 64 in two slots
  (32 in three shipped);
* ``warps2`` / ``warps8``: blocks of 8 or 32 rows (16 shipped);
* ``load1`` / ``load4``: 1 or 4 loading warps a block (2 shipped);
* ``slots2``: two tiles staged at once (three shipped);
* ``unroll2``: the loop over groups of four steps unrolled twice (not
  unrolled shipped).

Ablations take a part of the work out to show what it costs (their
results are wrong, reported and not checked): ``no_fill`` (the loading
warps fill no slot), ``no_reduce`` (the shuffles: a thread's four partial
sums added in place), ``bc_once`` (B and C read from shared memory once
per four steps).

With ``--parent DIR`` (a checkout of another commit, e.g. unpacked with
``git archive`` into a directory ``.gitignore`` lists) that checkout's
kernel is built and timed too.

Every kernel runs at zamba2-2.7b's prefill shape (``chip_smoke.SSM_MAIN``,
bf16): with ``a = 0`` it must equal the plain version bit for bit (the
parent's, which may sum in another order, only within tolerance), with
random ``a`` match it within ``chip_smoke.SSM_TOL``.
Times are CUDA events over back-to-back launches, taken in the order
parent, variants, variants reversed, parent.  Then the shipped kernel
runs for two seconds while ``nvidia-smi`` samples the SM clock and the
power draw, and ``cuobjdump -sass`` gives the instruction mix of its
main loop (bf16, N <= 64).

Prints one JSON line per kernel (a variant that does not build or does
not match is reported and not timed, and the exit code is then 1), then
the card's name and power limit; writes the lines, with each build's
``ptxas`` register and spill lines, to ``build/ssm_probe/ssm_probe.jsonl``.
Run from the repository root:

    python3 ssm_probe.py [--parent build/parent]

Each variant's edits must each match the source exactly once, or the
probe stops; ``tests/test_torch_core.py`` holds them to the source on
every test run, so an edit of the kernel that breaks a variant fails
there first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

SOURCE = cs.SRC / "repro_torch" / "kernels" / "csrc" / "ssm_scan.cu"
OUT = cs.ROOT / "build" / "ssm_probe"
REPS = 20

_BUTTERFLY = """#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float sum = part[u];
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum = sum + __shfl_xor_sync(kFullMask, sum, off);
      if (live && l == 0 && i0 + u < steps)
        y[static_cast<long long>(i0 + u) * P] = sum;
    }"""


def _const(name: str, shipped, value):
    """The edit that sets ``constexpr int name`` to ``value``."""
    return (rf"constexpr int {name} = {shipped};",
            f"constexpr int {name} = {value};")


#: variant -> [(pattern, replacement)], each pattern found exactly once
VARIANTS = {
    "shipped": [],
    "butterfly": [
        (r"const float sum = row_sum4\(part, odd, hi2\);\n.*?= sum;",
         _BUTTERFLY)],
    "steps16": [_const("kSteps", 32, 16)],
    "steps64": [_const("kSteps", 32, 64), _const("kSlots", 3, 2),
                # the widest states no longer fit a block; the probe runs N=64
                (r"static_assert\(kBytes <= 232448, .*?\);", "")],
    "warps2": [_const("kWarps", 4, 2)],
    "warps8": [_const("kWarps", 4, 8)],
    "load1": [_const("kLoadWarps", 2, 1)],
    "load4": [_const("kLoadWarps", 2, 4)],
    "slots2": [_const("kSlots", 3, 2)],
    "unroll2": [(r"#pragma unroll 1\n\s*for \(int i0 = 0;",
                 "#pragma unroll 2\n  for (int i0 = 0;")],
}

#: ablations: a part of the work taken out, to see what it costs; their
#: results are wrong and not checked
ABLATIONS = {
    "no_fill": [(r"fill_slot<T, K>\(smem \+ s \* L::kSlot, .*?, li\);", "")],
    "no_reduce": [(r"const float sum = row_sum4\(part, odd, hi2\);",
                   "const float sum = (part[0] + part[1]) + "
                   "(part[2] + part[3]);")],
    # B and C read once per four steps instead of once a step
    "bc_once": [(r"load4\(sB \+ at\), load4\(sC \+ at\)",
                 "load4(sB + at - u * L::kN), load4(sC + at - u * L::kN)")],
}


def variant_source(text: str, edits) -> str:
    for pattern, repl in edits:
        text, n = re.subn(pattern, lambda _m: repl, text, flags=re.S)
        if n != 1:
            raise SystemExit(f"ssm_probe: pattern {pattern!r} found {n} times")
    return text


def build(name: str, text: str):
    """One variant's source to its own library: (name, path or None if
    nvcc failed, log)."""
    from repro_torch.kernels._build import NVCC_FLAGS, find_nvcc

    src = OUT / f"{name}.cu"
    src.write_text(text)
    lib = OUT / f"lib{name}.so"
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode:
        return name, None, proc.stdout + proc.stderr
    return name, lib, proc.stdout + proc.stderr


def sass_loop(lib: Path,
              kernel: str = "ssm_scan_kernelI13__nv_bfloat16Li2E"):
    """The instruction mix of a kernel's main loop in a built library
    (``cuobjdump -sass``): of the backward branches, the one whose body
    holds the most FMUL, the smallest such.  Default: bf16 at N <= 64."""
    import collections

    from repro_torch.kernels._build import find_nvcc

    tool = Path(find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    body = next(part for part in re.split(r"\n\s*Function : ", sass)
                if kernel in part.split("\n", 1)[0])
    ins = [(int(at, 16), op.split()[-1].split(".")[0], rest)
           for at, op, rest in re.findall(
               r"/\*([0-9a-f]{4,})\*/\s+((?:@!?U?P\w+\s+)?[A-Z][A-Z0-9_.]*)"
               r"([^;]*);", body)]
    loops = []
    for at, op, rest in ins:
        target = re.search(r"0x([0-9a-f]+)", rest)
        if op == "BRA" and target and int(target.group(1), 16) < at:
            ops = [o for b, o, _ in ins if int(target.group(1), 16) <= b <= at]
            loops.append((ops.count("FMUL"), -len(ops), ops))
    ops = max(loops)[2]
    return {"instructions": len(ops),
            "mix": dict(collections.Counter(ops).most_common())}


def load(path: Path):
    lib = ctypes.CDLL(str(path))
    fn = lib.repro_ssm_scan
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launcher(torch, fn, args, y):
    x, a, dt, bm, cm = args
    b, h, s, p = x.shape
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        code = fn(x.data_ptr(), a.data_ptr(), dt.data_ptr(), bm.data_ptr(),
                  cm.data_ptr(), y.data_ptr(), b, h, s, p, bm.shape[-1], 1,
                  stream)
        cs.require(code == 0, f"ssm_probe: launch failed ({code})")
    return run


def event_ms(torch, run) -> float:
    run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(REPS):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def clocks_under_load(torch, run, seconds: float = 2.0):
    """SM clock (MHz) and power draw (W) that ``nvidia-smi`` samples every
    100 ms while ``run`` is launched back to back for ``seconds``."""
    import time

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            for _ in range(50):
                run()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=30)
    samples = [[float(v) for v in ln.split(",")] for ln in out.splitlines()
               if ln.strip()]
    return {"clocks_sm_mhz": [c for c, _ in samples],
            "power_draw_w": [p for _, p in samples]}


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None)
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("ssm_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(cs.SRC))
    from repro_torch.kernels import ssm_scan as ss

    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    jobs = {name: variant_source(text, edits)
            for name, edits in {**VARIANTS, **ABLATIONS}.items()}
    if opts.parent is not None:
        jobs["parent"] = (opts.parent
                          / SOURCE.relative_to(cs.ROOT)).read_text()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda kv: build(*kv), jobs.items()))
    failed = {name: log for name, path, log in built if path is None}
    fns = {name: load(path) for name, path, _ in built if path is not None}
    logs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, _, log in built}

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    b, h, s, p, n = cs.SSM_MAIN
    rnd = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                     device=device)
    x, bm, cm = (rnd(b, h, s, p).bfloat16(), rnd(b, s, n).bfloat16(),
                 rnd(b, s, n).bfloat16())
    dt = rnd(b, h, s).abs()
    cases = {"a0": (x, torch.zeros((b, h, s), device=device), dt, bm, cm),
             "a": (x, -rnd(b, h, s).abs() * 0.2, dt, bm, cm)}
    want = {k: ss.ssm_scan(*args, chunk=cs.SSM_CHUNK, impl="plain")
            for k, args in cases.items()}
    y = torch.empty((b, h, s, p), dtype=torch.float32, device=device)
    rows = {}
    for name, fn in fns.items():
        errs = {}
        for k, args in cases.items():
            y.fill_(float("nan"))
            launcher(torch, fn, args, y)()
            torch.cuda.synchronize()
            errs[k] = cs._max_abs(torch, y, want[k])
            tol = cs.SSM_TOL["bfloat16"]
            ok = (bool(torch.equal(y, want[k])) if k == "a0"
                  and name != "parent" else
                  bool(((y - want[k]).abs() <= tol + tol * want[k].abs())
                       .all()))
            if not ok and name not in ABLATIONS:
                failed[name] = f"{k}: max abs err {errs[k]}"
        rows[name] = {"probe": "ssm_scan", "variant": name,
                      "ablation": name in ABLATIONS,
                      "shape": list(cs.SSM_MAIN), "dtype": "bfloat16",
                      "max_abs_err_a0": errs["a0"],
                      "max_abs_err": errs["a"], "ptxas": logs[name],
                      "ms": []}
    order = [k for k in fns if k != "parent" and k not in failed]
    order = order + order[::-1]
    if "parent" in fns and "parent" not in failed:
        order = ["parent"] + order + ["parent"]
    for name in order:
        rows[name]["ms"].append(event_ms(torch, launcher(
            torch, fns[name], cases["a"], y)))
    rows["shipped"].update(clocks_under_load(
        torch, launcher(torch, fns["shipped"], cases["a"], y)))
    rows["shipped"]["sass_loop"] = sass_loop(
        next(path for name, path, _ in built if name == "shipped"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    with open(OUT / "ssm_probe.jsonl", "w") as fh:
        for row in rows.values():
            row["nvidia_smi"] = smi
            fh.write(json.dumps(row) + "\n")
            print(json.dumps({k: v for k, v in row.items() if k != "ptxas"}),
                  flush=True)
        for name, why in failed.items():
            row = {"probe": "ssm_scan", "variant": name, "failed": why}
            print(json.dumps(row), flush=True)
            fh.write(json.dumps(row) + "\n")
    print(smi, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
