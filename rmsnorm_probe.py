#!/usr/bin/env python3
"""Design variants and the launch path of the ``rmsnorm`` kernel on one GPU.

Each variant is ``src/repro_torch/kernels/csrc/rmsnorm.cu`` with one
design choice changed, built into a library of its own (one ``nvcc``
each, all started together):

* ``shipped``: the source as it is;
* ``threads128`` / ``threads512``: blocks of 128 or 512 threads (256
  shipped), so 4 or 1 chunks of 16 bytes a thread at 8 x 4096 bf16;
* ``pdl``: programmatic dependent launch.  The kernel is launched by
  ``cudaLaunchKernelEx`` with programmatic stream serialization, waits
  (``griddepcontrol.wait``) after gamma's loads and before x's, and lets
  the next launch start at once (``griddepcontrol.launch_dependents``).

Each variant must equal the plain version summed in its own order
(``_sum_squares`` with its block's threads) bit for bit at the decode
shapes (8 rows of 4096, 2560 and 5120, bf16, the layer's form), the
prefill shape (4096 x 4096) and a strided row (8 x 1001).  Then, at the
decode shapes, in the order variants, then reversed:

* ``device_us``: the kernel's device time (``torch.profiler``) over
  back-to-back launches;
* ``graph_us``: a CUDA graph of 64 launches, each norm reading the one
  before's output, replayed; the time a launch (CUDA events), where the
  gap between dependent kernels shows and where PDL would shorten it.

The ``host`` line times the pieces of the launch path on this machine's
host (perf_counter over 2,000 calls, the device keeping up): the whole
dispatch, the wrapper, the bare ``ctypes`` launch with packed arguments,
``torch.empty_like``, ``F.rms_norm`` and a one-element ``add_``.

Prints one JSON line per variant and the host line, then the card's name
and power limit; writes the lines, with each build's
``ptxas`` lines, to ``build/rmsnorm_probe/rmsnorm_probe.jsonl``.  Exits 1
when a variant does not build or does not match.  Run from the repository
root:

    python3 rmsnorm_probe.py

Each variant's edits must each match the source exactly once, or the
probe stops; ``tests/test_torch_core.py`` holds them to the source on
every test run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as cs

ROOT = Path(__file__).resolve().parent
SOURCE = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "rmsnorm.cu"
OUT = ROOT / "build" / "rmsnorm_probe"
DECODE = ((8, 4096), (8, 2560), (8, 5120))
CHECKED = DECODE + ((4096, 4096), (8, 1001))
CHAIN = 64

_WAIT = '  asm volatile("griddepcontrol.wait;" ::: "memory");\n' \
        '  asm volatile("griddepcontrol.launch_dependents;");\n'
_LAUNCH = """  kernel<<<static_cast<unsigned>(a.rows), kThreads, 0, stream>>>(
      static_cast<const T*>(a.x), static_cast<const T*>(a.gamma), static_cast<T*>(a.out), a.d,
      a.inv_d, a.eps);
  return cudaGetLastError();"""
_LAUNCH_EX = """  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(a.rows));
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(a.x),
                            static_cast<const T*>(a.gamma), static_cast<T*>(a.out), a.d,
                            a.inv_d, a.eps);"""
_X_AFTER_GAMMA = ("  // x after gamma: nothing above reads what an earlier "
                  "kernel may write\n")
_STRIDED_TOP = "  T* orow = out + base;\n\n  float acc = 0.0f;\n  for (long long"


def _threads(n: int):
    return ("constexpr int kThreads = 256;", f"constexpr int kThreads = {n};")


#: variant -> (block threads, [(text, replacement)]), each text found once
VARIANTS = {
    "shipped": (256, []),
    "threads128": (128, [_threads(128)]),
    "threads512": (512, [_threads(512)]),
    "pdl": (256, [(_X_AFTER_GAMMA, _X_AFTER_GAMMA + _WAIT),
                  (_STRIDED_TOP, _STRIDED_TOP.replace(
                      "\n\n", "\n" + _WAIT + "\n", 1)),
                  (_LAUNCH, _LAUNCH_EX)]),
}


def variant_source(text: str, edits) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f"rmsnorm_probe: {old!r} found "
                             f"{text.count(old)} times")
        text = text.replace(old, new)
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
    return name, (None if proc.returncode else lib), proc.stdout + proc.stderr


def load(path: Path):
    fn = ctypes.CDLL(str(path)).repro_rmsnorm
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launcher(torch, fn, x, g, out):
    """A call that launches ``fn``'s kernel on x -> out (layer form)."""
    from repro_torch.kernels import rmsnorm as rn

    rows, d = x.shape
    args = rn._ARGS.pack(x.data_ptr(), g.data_ptr(), out.data_ptr(), rows,
                         d, rn._inv(d), 1e-5, rn._DTYPES[x.dtype], 1)
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        cs.require(fn(args, stream) == 0, "rmsnorm_probe: launch failed")
    return run


def plain(torch, x, g, threads):
    """The plain version (layer form) summed in a block of ``threads``."""
    from repro_torch.kernels import rmsnorm as rn

    d = x.shape[-1]
    xf = x.float()
    ms = rn._sum_squares(xf, 16 // x.element_size(), threads) * rn._inv(d)
    y = xf * torch.sqrt(ms + 1e-5).reciprocal()
    return y.to(x.dtype) * g


def graph_us(torch, fn, x, g, outs) -> float:
    """Microseconds a launch of a captured chain of ``CHAIN`` dependent
    norms (each reads the one before's output), replayed."""
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for src, dst in zip([x] + outs[:-1], outs):
            launcher(torch, fn, src, g, dst)()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(20):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return 1e3 * start.elapsed_time(end) / (20 * CHAIN)


def host_us(torch, fn, n: int = 2000) -> float:
    """Host microseconds a call of ``fn`` (perf_counter, then a sync)."""
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * host / n


def host_line(torch) -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((8, 4096), generator=gen, device="cuda").bfloat16()
    g = torch.ones(4096, dtype=torch.bfloat16, device="cuda")
    out = torch.empty_like(x)
    fn, raw_stream, current_device = rn._entry()
    tiny = torch.zeros(8, device="cuda")

    def checks():        # the wrapper's checks, as it makes them
        index = x.get_device()
        if not x.is_cuda or g.get_device() != index:
            raise ValueError
        code = rn._DTYPES.get(x.dtype)
        if code is None or g.dtype != x.dtype:
            raise ValueError
        d = x.shape[-1] if x.dim() else 0
        if d < 1 or g.shape != (d,) or not (x.is_contiguous()
                                            and g.is_contiguous()):
            raise ValueError
        return x.numel() // d

    def guard():         # the guard the wrapper entered on every call
        with torch.cuda.device(x.device):
            pass

    calls = {"rmsnorm": lambda: rn.rmsnorm(x, g, layer_form=True),
             "rmsnorm_cuda": lambda: rn.rmsnorm_cuda(x, g, 1e-5, True),
             "ctypes_launch": launcher(torch, fn, x, g, out),
             "checks": checks,
             "pack_args": lambda: rn._ARGS.pack(
                 x.data_ptr(), g.data_ptr(), out.data_ptr(), 8, 4096,
                 rn._inv(4096), 1e-5, 1, 1),
             "stream_and_device": lambda: (raw_stream(0), current_device()),
             "stream_object": lambda: torch.cuda.current_stream(
                 x.device).cuda_stream,
             "device_guard": guard,
             "empty_like": lambda: torch.empty_like(x),
             "f_rms_norm": lambda: F.rms_norm(x, (4096,), g, 1e-5),
             "add_one_element": lambda: tiny.add_(1)}
    return {"probe": "rmsnorm", "host_us": {k: host_us(torch, fn)
                                            for k, fn in calls.items()},
            "shape": [8, 4096], "dtype": "bfloat16"}


def variants(torch) -> tuple:
    """Build, check and time every variant: (lines, failures)."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    jobs = {name: variant_source(text, edits)
            for name, (_, edits) in VARIANTS.items()}
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda kv: build(*kv), jobs.items()))
    failed = {name: log for name, path, log in built if path is None}
    fns = {name: load(path) for name, path, _ in built if path is not None}
    gen = torch.Generator(device="cuda").manual_seed(7)
    inputs = {}
    for rows, d in CHECKED:
        x = (3 * torch.randn((rows, d), generator=gen, device="cuda")
             ).bfloat16()
        g = (1 + torch.randn(d, generator=gen, device="cuda")).bfloat16()
        inputs[rows, d] = (x, g, torch.empty_like(x))
    rows = {}
    for name, fn in fns.items():
        threads = VARIANTS[name][0]
        for (r, d), (x, g, out) in inputs.items():
            out.fill_(float("nan"))
            launcher(torch, fn, x, g, out)()
            torch.cuda.synchronize()
            if not torch.equal(out, plain(torch, x, g, threads)):
                failed[name] = f"{r}x{d}: max abs err " + str(
                    cs._max_abs(torch, out, plain(torch, x, g, threads)))
        rows[name] = {"probe": "rmsnorm", "variant": name,
                      "threads": threads, "dtype": "bfloat16",
                      "checked": [list(s) for s in CHECKED],
                      "ptxas": [ln.strip() for ln in next(
                          log for n, _, log in built if n == name
                      ).splitlines() if "registers" in ln or "spill" in ln],
                      **{f"{k}_{r}x{d}": [] for k in ("device_us", "graph_us")
                         for r, d in DECODE}}
    order = [k for k in fns if k not in failed]
    for name in order + order[::-1]:
        for r, d in DECODE:
            x, g, out = inputs[r, d]
            rows[name][f"device_us_{r}x{d}"].append(1e3 * cs.device_ms(
                torch, launcher(torch, fns[name], x, g, out), 50))
            outs = [torch.empty_like(x) for _ in range(CHAIN)]
            rows[name][f"graph_us_{r}x{d}"].append(
                graph_us(torch, fns[name], x, g, outs))
    return list(rows.values()), failed


def main() -> int:
    import torch

    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        print("rmsnorm_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(cs.SRC))
    lines, failed = variants(torch)
    lines.append(host_line(torch))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    OUT.mkdir(parents=True, exist_ok=True)
    with open(OUT / "rmsnorm_probe.jsonl", "w") as fh:
        for row in lines:
            row["nvidia_smi"] = smi
            fh.write(json.dumps(row) + "\n")
            print(json.dumps({k: v for k, v in row.items() if k != "ptxas"}),
                  flush=True)
        for name, why in failed.items():
            row = {"probe": "rmsnorm", "variant": name, "failed": why}
            print(json.dumps(row), flush=True)
            fh.write(json.dumps(row) + "\n")
    print(smi, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
