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

With ``--bwd`` the probe measures the backward kernel
(``csrc/rmsnorm_bwd.cu``) instead, in a process of its own: this tree's
source (``tree``), its variants (:data:`BWD_VARIANTS`: 8 or 32 rows a
block, no prefetch of the next row), and with ``--parent DIR`` (a
checkout of another commit, e.g. unpacked with ``git archive`` into a
directory ``.gitignore`` lists) that checkout's, each built into a
library of its own.  At :data:`BWD_CASES` the tree's kernel and each
variant must equal ``rmsnorm_bwd_plain`` (with the variant's rows a
block) bit for bit; the parent's, which may sum in another order, only
within ``chip_smoke.LM_TOL`` normwise.  At the training shape (4096 rows
of 4096, bf16, the layer's form) it times, in the order parent, tree,
variants, reversed, parent, each kernel's device time by pass
(``torch.profiler``, grouped by kernel name) and its CUDA-event time
over back-to-back launches; then ``F.rms_norm``'s backward alone (a
retained graph) and its forward + backward the same two ways, and the
launch path (events of wrapper calls and bare launches; host pieces at 8
rows).  It writes ``build/rmsnorm_probe/rmsnorm_bwd_probe.jsonl``:

    python3 rmsnorm_probe.py --bwd [--parent build/parent]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
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
BWD_SOURCE = SOURCE.with_name("rmsnorm_bwd.cu")
_PREFETCH_IF = "    if (row + 1 < r1) {\n      const uint4* xr"
_COPY_NEXT = """      *reinterpret_cast<uint4*>(xv[j]) = *reinterpret_cast<const uint4*>(xn[j]);
      *reinterpret_cast<uint4*>(dv[j]) = *reinterpret_cast<const uint4*>(dn[j]);
"""
_LOAD_NEXT = """      const int c = j * kThreads + t;
      if (row + 1 < r1 && c < chunks) {
        *reinterpret_cast<uint4*>(xv[j]) =
            __ldg(reinterpret_cast<const uint4*>(x + (row + 1) * d) + c);
        *reinterpret_cast<uint4*>(dv[j]) =
            __ldg(reinterpret_cast<const uint4*>(dy + (row + 1) * d) + c);
      }
"""


def _bwd_rows(n: int):
    return ("constexpr int kRows = 16;", f"constexpr int kRows = {n};")


#: Backward variants: variant -> (rows a block, [(text, replacement)]),
#: each text found once.  ``rows8`` / ``rows32``: blocks of 8 or 32 rows
#: (16 shipped: 512 or 128 blocks at 4096 rows, the scratch 8 or 2 MB);
#: ``no_prefetch``: the next row's x and dy loaded after this row's dx is
#: written, in place of before its reduction (no second register set).
BWD_VARIANTS = {
    "tree": (16, []),
    "rows8": (8, [_bwd_rows(8)]),
    "rows32": (32, [_bwd_rows(32)]),
    "no_prefetch": (16, [(_PREFETCH_IF, _PREFETCH_IF.replace(
        "row + 1 < r1", "false", 1)), (_COPY_NEXT, _LOAD_NEXT)]),
}

#: The backward's cases: (rows, d, dtype, x offset in elements).  The
#: first is the training shape, the one timed; then fp32, the configs'
#: widths, and the rows of the strided kernel (d no multiple of the
#: 16-byte chunk, an x off its alignment, a row of 20,000 fp32).
BWD_CASES = ((4096, 4096, "bfloat16", 0), (4096, 4096, "float32", 0),
             (4096, 1280, "bfloat16", 0), (4096, 8192, "bfloat16", 0),
             (37, 1001, "bfloat16", 0), (37, 4096, "bfloat16", 1),
             (16, 20000, "float32", 0))

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


def load_bwd(path: Path, packed: bool):
    """The backward's entry point: packed arguments (``_BWD_ARGS``) and
    the stream, or, in a source without ``ReproRmsnormBwdArgs``, the
    twelve values and the stream."""
    fn = ctypes.CDLL(str(path)).repro_rmsnorm_bwd
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p] if packed else [
        ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                ctypes.c_float, ctypes.c_float, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn.packed = packed
    return fn


def bwd_launcher(torch, fn, x, g, dy, dx, dg, part):
    """A call that launches ``fn``'s backward (layer form) into dx, dg,
    with ``part`` as its fp32 scratch (large enough for any rows a
    block)."""
    from repro_torch.kernels import rmsnorm as rn

    rows, d = x.shape
    vals = (x.data_ptr(), g.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            dg.data_ptr(), part.data_ptr(), rows, d, rn._inv(d), 1e-5,
            rn._DTYPES[x.dtype], 1)
    stream = torch.cuda.current_stream().cuda_stream
    args = (rn._BWD_ARGS.pack(*vals), stream) if fn.packed else (*vals,
                                                                 stream)

    def run():
        cs.require(fn(*args) == 0, "rmsnorm_probe: backward launch failed")
    return run


def _normwise(torch, got, want, dtype) -> bool:
    """||got - want|| <= LM_TOL ||want||: the parent's bar (its sums run in
    another order, and an elementwise bar fails where a column's terms
    cancel)."""
    g, w = got.double(), want.double()
    return bool((g - w).norm() <= cs.LM_TOL[dtype] * w.norm())


def kernel_us(torch, run, reps: int = 50) -> dict:
    """Device microseconds a call of ``run`` by kernel name (the function
    name before its template or argument list), from ``torch.profiler``
    over ``reps`` back-to-back calls after one warm-up call."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = re.search(r"(\w+)[<(]", e.key)
            name = m.group(1) if m else e.key[:60]
            out[name] = out.get(name, 0.0) + cs._self_device_us(e) / reps
    cs.require(sum(out.values()) > 0, "rmsnorm_probe: no device time")
    return out


def bwd_inputs(torch, gen, rows, d, dtype, skip):
    td = getattr(torch, dtype)
    x = (3 * torch.randn(rows * d + skip, generator=gen, device="cuda")
         ).to(td)[skip:].view(rows, d)
    g = (1 + torch.randn(d, generator=gen, device="cuda")).to(td)
    dy = torch.randn((rows, d), generator=gen, device="cuda").to(td)
    return x, g, dy


def backward(torch, parent) -> tuple:
    """Build, check and time this tree's backward kernel (and the
    parent's): (lines, failures)."""
    import torch.nn.functional as F

    from repro_torch.kernels import rmsnorm as rn

    OUT.mkdir(parents=True, exist_ok=True)
    text = BWD_SOURCE.read_text()
    jobs = {name: variant_source(text, edits)
            for name, (_, edits) in BWD_VARIANTS.items()}
    if parent is not None:
        jobs["parent"] = (parent / BWD_SOURCE.relative_to(ROOT)).read_text()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda kv: build(f"bwd_{kv[0]}", kv[1]),
                              jobs.items()))
    failed = {name[4:]: log for name, path, log in built if path is None}
    fns = {name[4:]: load_bwd(path, "ReproRmsnormBwdArgs" in jobs[name[4:]])
           for name, path, _ in built if path is not None}
    rows = {name[4:]: {"probe": "rmsnorm_bwd", "kernel": name[4:],
                       "ptxas": [ln.strip() for ln in log.splitlines()
                                 if "registers" in ln or "spill" in ln]}
            for name, _, log in built}
    gen = torch.Generator(device="cuda").manual_seed(11)
    shipped_rows = rn.BWD_ROWS
    for r, d, dtype, skip in BWD_CASES:
        x, g, dy = bwd_inputs(torch, gen, r, d, dtype, skip)
        part = torch.empty((r, d), dtype=torch.float32, device="cuda")
        for name, fn in fns.items():
            # each variant's twin: the plain version with its rows a block
            rn.BWD_ROWS = BWD_VARIANTS.get(name, (shipped_rows,))[0]
            try:
                want = rn.rmsnorm_bwd_plain(x, g, dy, layer_form=True)
            finally:
                rn.BWD_ROWS = shipped_rows
            dx, dg = torch.full_like(x, float("nan")), torch.empty_like(g)
            bwd_launcher(torch, fn, x, g, dy, dx, dg, part)()
            torch.cuda.synchronize()
            tag = f"{r}x{d} {dtype} offset {skip}"
            errs = [cs._max_abs(torch, a.view(-1, a.shape[-1]),
                                b.view(-1, b.shape[-1]))
                    for a, b in zip((dx, dg), want)]
            same = all(bool(torch.equal(a, b)) for a, b in zip((dx, dg),
                                                                want))
            rows[name].setdefault("max_abs_err", {})[tag] = errs
            rows[name].setdefault("bitwise_equal", {})[tag] = same
            ok = same if name != "parent" else all(
                _normwise(torch, a, b, dtype) for a, b in zip((dx, dg),
                                                              want))
            if not ok:
                failed[name] = f"{tag}: max abs err {errs}"
    r, d, dtype, _ = BWD_CASES[0]
    x, g, dy = bwd_inputs(torch, gen, r, d, dtype, 0)
    dx, dg = torch.empty_like(x), torch.empty_like(g)
    part = torch.empty((r, d), dtype=torch.float32, device="cuda")
    order = [k for k in BWD_VARIANTS if k in fns and k not in failed]
    order = order + order[::-1]
    if "parent" in fns and "parent" not in failed:
        order = ["parent"] + order + ["parent"]
    for name in order:
        run = bwd_launcher(torch, fns[name], x, g, dy, dx, dg, part)
        rows[name].setdefault("device_us", []).append(kernel_us(torch, run))
        rows[name].setdefault("event_ms", []).append(cs.call_ms(torch, run,
                                                                50))
    xr = x.detach().clone().requires_grad_(True)
    gr = g.detach().clone().requires_grad_(True)
    y = F.rms_norm(xr, (d,), gr, 1e-5)
    calls = {"bwd": lambda: torch.autograd.grad(y, (xr, gr), dy,
                                                retain_graph=True),
             "fwd_bwd": lambda: F.rms_norm(xr, (d,), gr, 1e-5).backward(dy)}
    library = {"probe": "rmsnorm_bwd", "kernel": "F.rms_norm"}
    for name, fn in calls.items():
        library[f"{name}_device_us"] = kernel_us(torch, fn)
        library[f"{name}_event_ms"] = cs.call_ms(torch, fn, 50)
    lines = list(rows.values()) + [library]
    if "tree" in fns and "tree" not in failed:
        # the launch path: events of wrapper calls beside bare launches at
        # the training shape; its host pieces at 8 rows, where the device
        # keeps up with the host
        wrapper = (lambda: rn.rmsnorm_bwd(x, g, dy))
        bare = bwd_launcher(torch, fns["tree"], x, g, dy, dx, dg, part)
        times = {"wrapper_event_ms": cs.call_ms(torch, wrapper, 50),
                 "bare_event_ms": cs.call_ms(torch, bare, 50)}
        xs, gs, dys = bwd_inputs(torch, gen, 8, d, dtype, 0)
        small = {"rmsnorm_bwd": lambda: rn.rmsnorm_bwd(xs, gs, dys),
                 "ctypes_launch": bwd_launcher(
                     torch, fns["tree"], xs, gs, dys, torch.empty_like(xs),
                     torch.empty_like(gs), part),
                 "three_empties": lambda: (
                     torch.empty_like(xs), torch.empty_like(gs),
                     torch.empty((1, d), dtype=torch.float32,
                                 device="cuda")),
                 "pack_args": lambda: rn._BWD_ARGS.pack(
                     0, 0, 0, 0, 0, 0, 8, d, rn._inv(d), 1e-5, 1, 1)}
        times["host_us_8_rows"] = {k: host_us(torch, fn)
                                   for k, fn in small.items()}
        lines.append({"probe": "rmsnorm_bwd", "kernel": "tree",
                      "launch_path": times})
    for line in lines:
        line.update(shape=[r, d], dtype=dtype, layer_form=True)
    return lines, failed


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--bwd", action="store_true",
                        help="measure the backward kernel")
    parser.add_argument("--parent", type=Path, default=None,
                        help="a checkout whose backward kernel is timed "
                             "beside this tree's (with --bwd)")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("rmsnorm_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(cs.SRC))
    if opts.bwd:
        lines, failed = backward(torch, opts.parent)
    else:
        lines, failed = variants(torch)
        lines.append(host_line(torch))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    OUT.mkdir(parents=True, exist_ok=True)
    out = "rmsnorm_bwd_probe.jsonl" if opts.bwd else "rmsnorm_probe.jsonl"
    with open(OUT / out, "w") as fh:
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
