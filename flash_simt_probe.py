#!/usr/bin/env python3
"""The SIMT flash kernel against another commit's and its design variants,
timed side by side on one GPU.

Each variant is ``src/repro_torch/kernels/csrc/flash_attention.cu`` with
one design choice moved, built into a library of its own (one ``nvcc``
each, all started together):

* ``shipped``: the source as it is;
* ``tn4``: 4 keys a thread (16 key lanes, 256 threads, 128 registers at
  most) in place of 8 at dh <= 80;
* ``tm4``: 4 rows and 4 keys a thread (64-row query tiles, 256 threads)
  at dh 80 as above it;
* ``unroll4`` / ``unroll16``: the score loop over d unrolled 4 or 16
  times (8 shipped);
* ``pv_unroll8``: the PV loop over keys unrolled 8 times (4 shipped);
* ``one_block``: launch bounds asking for one block an SM (two shipped up
  to dh 128).

Ablations take a part of each tile's work out to show what it costs
(their results are wrong, reported and not checked): ``no_exp`` (p and
corr without ``expf``), ``no_scores`` (the score loop), ``no_pv`` (the PV
loop), ``no_stage`` (K and V staged for the first tile only).

With ``--parent DIR`` (a checkout of another commit, e.g. unpacked with
``git archive`` into a directory ``.gitignore`` lists) that checkout's
kernel is built and run too; it takes the same C arguments.

Every kernel runs :data:`chip_smoke.FLASH_SIMT_CASES` (fp32 and bf16 at
every head dim, causal, full, windowed, GQA, zamba2-2.7b's and hubert's
prefill shapes) twice: each run must equal ``flash_attention_plain`` bit
for bit where cuBLAS sums the plain loop's products as single chains
(``chip_smoke.plain_chains_sequential``; the parent is reported, not
held).  Then each times zamba2's
(1, 32/32, 4096, 80) causal and hubert's (1, 16/16, 4096, 80) full
attention in bf16 with CUDA events over back-to-back launches, in the
order parent, variants, variants reversed, parent, beside SDPA; the
shipped kernel then runs for two seconds while ``nvidia-smi`` samples
the SM clock and the power draw.  Last, the shipped kernel and the
parent's take (1, 16/16, 2048, dh) causal at every head dim, fp32 and
bf16, in the order parent, shipped, shipped, parent.

Prints one JSON line per kernel and measurement (a kernel that does not
build or does not match is reported and not timed; the exit code is then
1), then the card's name and power limit; writes the lines, with each
build's ``ptxas`` register and spill lines for the flash kernel (and, for
the shipped and parent kernels, the instruction mix of the two inner
loops at bf16 dh 80 from ``cuobjdump -sass``), to
``build/flash_simt_probe/probe.jsonl``.  Run from the repository root:

    python3 flash_simt_probe.py [--parent build/parent] [--variants a,b]
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

SOURCE = cs.SRC / "repro_torch" / "kernels" / "csrc" / "flash_attention.cu"
OUT = cs.ROOT / "build" / "flash_simt_probe"
REPS = 10
#: the timed shapes: (tag, (B, H, Hkv, S, dh), causal)
TIMED = (("zamba2", cs.FLASH_ZAMBA, True),
         ("encoder",) + cs.FLASH_FAMILIES["encoder"])

#: (B, H = Hkv, S) of the sweep over head dims, causal
HEAD_DIM_SHAPE = (1, 16, 2048)

#: variant -> [(pattern, replacement)], each pattern found exactly once
VARIANTS = {
    "shipped": [],
    "tn4": [(r"kTN = kTM;", "kTN = 4;")],
    "tm4": [(r"kTM = DH <= 80 \? 8 : 4;", "kTM = DH <= 64 ? 8 : 4;")],
    "unroll4": [(r"#pragma unroll 8\n(\s*)for \(int d = 0;",
                 "#pragma unroll 4\n    for (int d = 0;")],
    "unroll16": [(r"#pragma unroll 8\n(\s*)for \(int d = 0;",
                  "#pragma unroll 16\n    for (int d = 0;")],
    "pv_unroll8": [(r"#pragma unroll 4\n(\s*)for \(int kk = 0;",
                    "#pragma unroll 8\n    for (int kk = 0;")],
    "one_block": [(r"kMinBlocks = DH <= 128 \? 2 : 1;", "kMinBlocks = 1;")],
}

#: ablations: a part of each tile's work taken out, to see what it costs;
#: their results are wrong, reported and not checked
ABLATIONS = {
    "no_exp": [(r"p\[a\] = expf\(s\[i\]\[a\] - m_new\);",
                "p[a] = s[i][a] - m_new;"),
               (r"const float corr = expf\(m_old - m_new\);",
                "const float corr = m_old - m_new;")],
    "no_scores": [(r"for \(int d = 0; d < DH; \+\+d\)",
                   "for (int d = 0; d < 0; ++d)")],
    "no_pv": [(r"for \(int kk = 0; kk < kBK; \+\+kk\)",
               "for (int kk = 0; kk < 0; ++kk)")],
    "no_stage": [(r"(stage_t<T, DH, kBK / 4, true>\(kh)",
                  "if (kt == 0) stage_t<T, DH, kBK / 4, true>(kh"),
                 (r"(stage_rows<T, DH>\(vh)",
                  "if (kt == 0) stage_rows<T, DH>(vh")],
}


def variant_source(text: str, edits) -> str:
    for pattern, repl in edits:
        text, n = re.subn(pattern, lambda _m: repl, text, flags=re.S)
        if n != 1:
            raise SystemExit(f"flash_simt_probe: pattern {pattern!r} found "
                             f"{n} times")
    return text


def build(name: str, text: str):
    """One kernel's source to its own library: (name, path or None if
    nvcc failed, the flash kernel's ptxas lines, the whole log)."""
    from repro_torch.kernels._build import NVCC_FLAGS, find_nvcc

    src = OUT / f"{name}.cu"
    src.write_text(text)
    lib = OUT / f"lib{name}.so"
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-shared", "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    ptxas, fn = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) "
                      r"'(\S+)'", line)
        if m:
            fn = m.group(1)
        elif fn and "flash_kernel" in fn and re.search(
                r"registers|spill", line):
            ptxas.append(f"{fn}: {line.strip()}")
    return name, (None if proc.returncode else lib), ptxas, log


def sass_loops(lib: Path, kernel: str = "flash_kernelI13__nv_bfloat16Li80E"):
    """The score and PV loops of a built library's kernel (``cuobjdump
    -sass``; default bf16 at dh 80): of its backward branches' bodies, the
    two with the largest share of FFMA, each as its instruction count and
    mix."""
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
            loops.append((ops.count("FFMA") / len(ops), len(ops), ops))
    return [{"instructions": n, "mix": dict(collections.Counter(ops)
                                            .most_common(4))}
            for _, n, ops in sorted(loops, reverse=True)[:2]]


def load(path: Path):
    fn = ctypes.CDLL(str(path)).repro_flash_attention
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def launcher(torch, fn, q, k, v, causal, window):
    """A function that launches ``fn`` into a fresh output and returns it."""
    from repro_torch.kernels import flash_attention as fa

    b, h, sq, dh = q.shape
    hkv, sk = k.shape[1], k.shape[2]

    def run():
        out = torch.empty_like(q)
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  b, h, hkv, sq, sk, dh, fa.softmax_scale(dh), int(causal),
                  window, 0 if q.dtype == torch.float32 else 1,
                  torch.cuda.current_stream().cuda_stream)
        cs.require(code == 0, f"flash_simt_probe: launch failed ({code})")
        return out
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


def emit(record, lines):
    lines.append(record)
    print(json.dumps(record), flush=True)


def main() -> int:
    import torch
    import torch.nn.functional as F

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--parent", type=Path, default=None)
    parser.add_argument("--variants",
                        default=",".join([*VARIANTS, *ABLATIONS]))
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_simt_probe: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(cs.SRC))
    import ssm_probe

    from repro_torch.kernels import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    text = SOURCE.read_text()
    edits = {**VARIANTS, **ABLATIONS}
    jobs = {name: variant_source(text, edits[name])
            for name in opts.variants.split(",")}
    if opts.parent is not None:
        jobs["parent"] = (opts.parent / SOURCE.relative_to(cs.ROOT)) \
            .read_text()
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(lambda kv: build(*kv), jobs.items()))
    lines, fns, failed = [], {}, set()
    for name, lib, ptxas, log in built:
        emit({"probe": "build", "kernel": name, "ok": lib is not None,
              "ptxas": ptxas, **({} if lib else {"log": log[-3000:]}),
              **({"sass_loops": sass_loops(lib)} if lib and name in (
                  "shipped", "parent") else {})}, lines)
        if lib is None:
            failed.add(name)
        else:
            fns[name] = load(lib)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    timed = {}
    for shape, dtype, causal, window in cs.FLASH_SIMT_CASES:
        b, h, hkv, s, dh = shape
        td = getattr(torch, dtype)
        q, k, v = (torch.randn(sh, generator=gen, device="cuda").to(td)
                   for sh in ((b, h, s, dh), (b, hkv, s, dh),
                              (b, hkv, s, dh)))
        want = fa.flash_attention_plain(q, k, v, causal, window)
        sequential = cs.plain_chains_sequential(torch, q, k)
        for name, fn in fns.items():
            run = launcher(torch, fn, q, k, v, causal, window)
            got, again = run(), run()
            torch.cuda.synchronize()
            equal = bool(torch.equal(got, want) and torch.equal(again, got))
            err = cs._max_abs(torch, got, want)
            if (not equal and sequential and name != "parent"
                    and name not in ABLATIONS):
                failed.add(name)
            emit({"probe": "case", "kernel": name, "shape": shape,
                  "dtype": dtype, "causal": causal, "window": window,
                  "bitwise": equal, "max_abs_err": err,
                  "plain_chains_sequential": sequential}, lines)
        for tag, tshape, tcausal in TIMED:
            if (shape, causal, window, dtype) == (tshape, tcausal, 0,
                                                  "bfloat16"):
                timed[tag] = (q, k, v, causal)
        del want

    for tag, (q, k, v, causal) in timed.items():
        order = [n for n in fns if n != "parent" and n not in failed]
        if "shipped" in order:
            order.remove("shipped")
            order.insert(0, "shipped")
        if "parent" in fns:
            order = ["parent"] + order + order[::-1] + ["parent"]
        else:
            order = order + order[::-1]
        runs = {n: launcher(torch, fns[n], q, k, v, causal, 0)
                for n in set(order)}
        times = {}
        for name in order:
            times.setdefault(name, []).append(event_ms(torch, runs[name]))
        sdpa = event_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True))
        b, h, s, dh = q.shape
        pairs = fa.simt_tile_pairs(s, s, dh, h, b, causal, 0)
        emit({"probe": "times", "shape": tag, "ms": times, "sdpa_ms": sdpa,
              "ffma_floor_ms": 1e3 * 2 * dh * pairs / cs.FP32_LANE_OPS_PER_S,
              "reps": REPS}, lines)
        if "shipped" in runs:
            emit({"probe": "clocks", "shape": tag, "kernel": "shipped",
                  **ssm_probe.clocks_under_load(torch, runs["shipped"])},
                 lines)
    # every head dim the kernel is built for, shipped against the parent
    for dtype, dh in ((d, dh) for d in ("float32", "bfloat16")
                      for dh in fa.HEAD_DIMS):
        b, h, s = HEAD_DIM_SHAPE
        q, k, v = (torch.randn((b, h, s, dh), generator=gen,
                               device="cuda").to(getattr(torch, dtype))
                   for _ in range(3))
        order = [n for n in ("parent", "shipped") if n in fns]
        order = order + order[::-1]
        times = {}
        for name in order:
            times.setdefault(name, []).append(event_ms(
                torch, launcher(torch, fns[name], q, k, v, True, 0)))
        emit({"probe": "head_dim", "dtype": dtype, "dh": dh,
              "shape": [b, h, h, s, dh], "causal": True, "ms": times,
              "ffma_floor_ms": 1e3 * 2 * dh * fa.simt_tile_pairs(
                  s, s, dh, h, b, True, 0) / cs.FP32_LANE_OPS_PER_S}, lines)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"probe": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "failed": sorted(failed)}, lines)
    (OUT / "probe.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in lines))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
