"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, on first use, into
``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``).  Each source compiles to an object in its own ``nvcc``
process, all started together, and one more ``nvcc`` links them.  The
library's file name carries a hash of the sources, the headers they
include and the flags, so an
edited source is rebuilt and an unchanged one is loaded as built.  Nothing here runs at import time: this module is
imported on machines with no CUDA toolkit, where only the plain PyTorch
versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, NamedTuple, Optional

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = ("power_step.cu", "rmsnorm.cu", "flash_attention.cu",
            "flash_attention_tc.cu", "ssm_scan.cu", "rmsnorm_bwd.cu",
            "flash_attention_bwd.cu", "flash_attention_bwd_tc.cu",
            "ssm_scan_bwd.cu", "ssm_scan_bwd_tc.cu")
#: Headers the sources include: part of the library's hash, not compiled
#: on their own.
_HEADERS = ("hopper_tc.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: ``--fmad=false`` keeps every multiply and add rounding on its own (no
#: FMA contraction), and the absence of ``--use_fast_math`` keeps IEEE
#: division: the kernels then round exactly as their plain versions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


class KernelLibrary(NamedTuple):
    """The loaded library and how it was obtained."""

    lib: ctypes.CDLL
    path: Path
    build_s: float      # nvcc wall seconds (0.0 when loaded as built)
    log: str            # nvcc/ptxas output of this process's build
    source_s: Dict[str, float]  # each source's nvcc seconds (empty if built)


def find_nvcc() -> str:
    """``nvcc`` on PATH, else under ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built on this machine")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES + _HEADERS:
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    lib.repro_power_step.argtypes = [_P] * 20 + [_I, _I, _I, _LL, _LL, _I, _P]
    lib.repro_power_step.restype = _I
    lib.repro_waterfill.argtypes = [_P] * 5 + [_I, _I, _LL, _P]
    lib.repro_waterfill.restype = _I
    lib.repro_wave_run.argtypes = [_P, _P]     # &ReproWaveArgs, stream
    lib.repro_wave_run.restype = _I
    lib.repro_rmsnorm.argtypes = [ctypes.c_char_p, _P]  # packed args
    lib.repro_rmsnorm.restype = _I
    lib.repro_flash_attention.argtypes = [_P] * 4 + [_I] * 6 + [_F] + \
        [_I] * 3 + [_P]
    lib.repro_flash_attention.restype = _I
    lib.repro_flash_attention_tc.argtypes = [_P] * 4 + [_I] * 6 + [_F] + \
        [_I] * 2 + [_P]
    lib.repro_flash_attention_tc.restype = _I
    lib.repro_ssm_scan.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    lib.repro_ssm_scan.restype = _I
    lib.repro_ssm_scan_bwd.argtypes = [_P] * 12 + [_I] * 6 + [_P]
    lib.repro_ssm_scan_bwd.restype = _I
    lib.repro_ssm_scan_bwd_workspace.argtypes = [_I] * 5
    lib.repro_ssm_scan_bwd_workspace.restype = _LL
    lib.repro_ssm_scan_bwd_tc.argtypes = [_P] * 12 + [_I] * 5 + [_P]
    lib.repro_ssm_scan_bwd_tc.restype = _I
    lib.repro_ssm_scan_bwd_tc_workspace.argtypes = [_I] * 5
    lib.repro_ssm_scan_bwd_tc_workspace.restype = _LL
    lib.repro_rmsnorm_bwd.argtypes = [ctypes.c_char_p, _P]  # packed args
    lib.repro_rmsnorm_bwd.restype = _I
    lib.repro_flash_attention_bwd.argtypes = [_P] * 9 + [_I] * 6 + [_F] + \
        [_I] * 3 + [_P]
    lib.repro_flash_attention_bwd.restype = _I
    lib.repro_flash_attention_bwd_tc.argtypes = [_P] * 9 + [_I] * 6 + \
        [_F] + [_I] * 2 + [_P]
    lib.repro_flash_attention_bwd_tc.restype = _I
    lib.repro_cuda_error_string.argtypes = [_I]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p


def _compile(nvcc: str, name: str, obj: Path):
    """One source to one object: (output, return code, wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                           str(_CSRC / name)], capture_output=True, text=True)
    return proc.stdout + proc.stderr, proc.returncode, time.perf_counter() - t0


def _link(nvcc: str, objs, out: Path):
    """The objects to one shared library: (output, return code)."""
    proc = subprocess.run([nvcc, "-shared", "-o", str(out), *map(str, objs)],
                          capture_output=True, text=True)
    return proc.stdout + proc.stderr, proc.returncode


def _open(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    return lib


def _load() -> KernelLibrary:
    path = BUILD_DIR / f"libreprotorch-{_digest()}.so"
    build_s, log, source_s = 0.0, "", {}
    if not path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = find_nvcc()
        tag = f"{path.stem}.{os.getpid()}"
        objs = [BUILD_DIR / f"{tag}.{Path(name).stem}.o" for name in _SOURCES]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(_SOURCES)) as pool:
            outs = list(pool.map(lambda a: _compile(nvcc, *a),
                                 zip(_SOURCES, objs)))
        log = "".join(f"[{name}]\n{out}"
                      for name, (out, _, _) in zip(_SOURCES, outs))
        source_s = {name: sec for name, (_, _, sec) in zip(_SOURCES, outs)}
        failed = [name for name, (_, rc, _) in zip(_SOURCES, outs) if rc]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        link_log, rc = _link(nvcc, objs, tmp)
        build_s = time.perf_counter() - t0
        log += link_log
        for obj in objs:
            obj.unlink(missing_ok=True)
        if rc != 0:
            raise RuntimeError(f"nvcc link failed ({rc}):\n{log}")
        os.replace(tmp, path)        # atomic: concurrent builders agree
    return KernelLibrary(lib=_open(path), path=path, build_s=build_s,
                         log=log, source_s=source_s)


#: The loaded library (None until the first :func:`load_library`), and
#: whether a caller has claimed its build (:func:`claim_build`).  Both
#: change only under ``_LOCK``: the sweep service launches from its own
#: threads, and two first calls must not both build.
_LOCK = threading.Lock()
_LIBRARY: Optional[KernelLibrary] = None
_CLAIMED = False


def load_library() -> KernelLibrary:
    """Build (if needed) and load the kernel library, once per process,
    whichever thread calls first (the others wait for that build)."""
    global _LIBRARY
    lib = _LIBRARY
    if lib is None:
        with _LOCK:
            if _LIBRARY is None:
                _LIBRARY = _load()
            lib = _LIBRARY
    return lib


def library_loaded() -> bool:
    """True once :func:`load_library` has returned in this process."""
    return _LIBRARY is not None


def claim_build() -> float:
    """The nvcc seconds of this process's build to the first caller that
    asks after it, 0.0 to every other caller (and when the library was
    loaded as built): so exactly one dispatch reports the build."""
    global _CLAIMED
    with _LOCK:
        if _LIBRARY is None or _CLAIMED:
            return 0.0
        _CLAIMED = True
        return _LIBRARY.build_s


def check(code: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if code != 0:
        msg = load_library().lib.repro_cuda_error_string(code)
        raise RuntimeError(f"{what} kernel launch failed: CUDA error "
                           f"{code} ({msg.decode() if msg else '?'})")
