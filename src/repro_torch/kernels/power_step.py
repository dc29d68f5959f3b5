"""Fused power-redistribution wave step: plain PyTorch version + CUDA kernel.

One wave of the batched simulator's hot path, per scenario row:

1. **idle-power reclamation / redistribution** (optional): reclaim the
   idle draw of non-running lanes and water-fill the rest of the row's
   current bound over the running ones (the oracle policy's cap rule),
2. **LUT power->frequency translation**: the highest DVFS state fitting
   each cap, duty states below ``p_min``, as an ascending scan over the
   state table,
3. **per-lane rates**: ``speed * duty / (rho * f_nom/f + (1 - rho))`` for
   running lanes,
4. **earliest-event reduction**: per-lane completion times
   ``remaining / rate`` and their row minimum, plus the row's cluster
   power.

The same source holds the whole wave loop: :func:`wave_run_cuda` runs
every row of a batch through its settle steps and waves to its end in
one launch, on the engine's state in place (see
:mod:`repro_torch.backends.engine`, whose lockstep loop is its plain
version).

Lanes are ``(B, N)`` float32 and row scalars ``(B, 1)``: the engine steps
all rows of a batch together, so the reference's per-row ``(1, N)`` /
``(1, 1)`` is the B=1 case.  :class:`StepTables` holds one cluster shared
by every row (state tables ``(S, N)``, lane tables ``(1, N)``) or one per
row (``(B, S, N)`` / ``(B, N)``).

:func:`power_step_plain` transcribes the reference's ``_step_math`` op
for op; its row sums (:func:`row_sum`) take the fixed order of the CUDA
kernel's warp reduction, so the kernel and its plain version agree bit
for bit on the card.  :func:`power_step` dispatches on the tensors'
device: the plain version for CPU tensors, the hand-written kernel
(``csrc/power_step.cu``) for CUDA tensors, which it launches or raises.
``impl="plain"`` forces the plain version on the card, to compare the two.

Rate-less lanes get the finite sentinel :data:`BIG_TIME` instead of
``inf``; callers treat anything above ``BIG_TIME / 2`` as "no event".
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.power import DUTY_FLOOR

#: Finite stand-in for "no completion event" (kernel-safe vs inf).
BIG_TIME = 1e30

#: Cap-fitting tolerance for the translator: float32 ILP caps that equal
#: a state power can round one ulp below it; ``1e-6`` absorbs that and
#: sits far under any real LUT state spacing.
FIT_ATOL = 1e-6

#: Largest lane count the kernel takes (one warp, 8 lanes per thread).
MAX_LANES = 256

#: Kernel launches per entry point, counted where each launch happens.
LAUNCHES: Counter = Counter(power_step=0, waterfill=0, wave_run=0)

#: Cap rules of the whole-row loop: a policy's ``kernel_mode`` -> the
#: kernel's code (``Mode`` in ``csrc/power_step.cu``).
WAVE_MODES = {"nominal": 0, "job_caps": 1, "redistribute": 2,
              "heuristic": 3, "learned": 4}

#: The learned policy's weights, in the order and shapes the kernel's
#: ``learned`` mode reads them from one packed float32 buffer (8 features
#: -> 16 -> 16 -> 1; ``kMlp*`` in ``csrc/power_step.cu``).
MLP_LAYOUT = (("W1", (8, 16)), ("b1", (16,)), ("W2", (16, 16)),
              ("b2", (16,)), ("w3", (16,)), ("b3", ()))


class StepTables(NamedTuple):
    """Per-cluster LUT constants on one device.

    ``state_p``/``state_f`` are ``(S, N)`` (shared) or ``(B, S, N)``
    (stacked) — states lead so the translation scans the state axis;
    lane tables are ``(1, N)`` (shared) or ``(B, N)`` (stacked).
    """

    state_p: torch.Tensor    # full-load power per state, +inf padded
    state_f: torch.Tensor    # frequency per state
    idle_w: torch.Tensor
    f_min: torch.Tensor
    f_nom: torch.Tensor
    span: torch.Tensor       # p_min - idle_w
    speed: torch.Tensor
    cap_floor: torch.Tensor
    p_max: torch.Tensor

    @property
    def stacked(self) -> bool:
        return self.state_p.dim() == 3


def step_tables(table, device="cpu", dtype=torch.float32) -> StepTables:
    """Build :class:`StepTables` from a
    :class:`~repro_torch.core.power.LUTTable`: a shared single-cluster
    table (``(N, S)`` state tables) or a per-row stacked one from
    :func:`~repro_torch.core.power.stack_lut_tables` (``(B, N, S)``)."""
    def put(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device).contiguous()

    lane = (lambda a: put(a)) if np.ndim(table.state_p) == 3 else \
        (lambda a: put(a)[None, :])
    return StepTables(
        state_p=put(np.swapaxes(np.asarray(table.state_p), -1, -2)),
        state_f=put(np.swapaxes(np.asarray(table.state_f), -1, -2)),
        idle_w=lane(table.idle_w), f_min=lane(table.f_min),
        f_nom=lane(table.f_nom), span=lane(table.span),
        speed=lane(table.speed), cap_floor=lane(table.cap_floor),
        p_max=lane(table.p_max))


# ------------------------------------------------------------ plain version
def row_sum(x: torch.Tensor) -> torch.Tensor:
    """``(B, N) -> (B, 1)`` sum in the kernel's order: lane ``i`` is slot
    ``i // 32`` of thread ``i % 32``; each thread sums its slots in
    order, then a butterfly adds thread ``t + off`` into ``t`` for
    ``off = 16, 8, 4, 2, 1``.  Zero padding adds nothing."""
    b, n = x.shape
    slots = -(-n // 32)
    v = F.pad(x, (0, 32 * slots - n)).view(b, slots, 32)
    acc = v[:, 0]
    for s in range(1, slots):
        acc = acc + v[:, s]
    for off in (16, 8, 4, 2, 1):
        acc = acc[:, :off] + acc[:, off:2 * off]
    return acc


def translate_caps(tab: StepTables, caps: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Power-to-frequency translation: caps ``(B, N)`` -> (freq, duty,
    power).  States are scanned in ascending order, so the last fitting
    state — the highest — wins; +inf padding rows never fit."""
    n_states = tab.state_p.shape[-2]
    freq = tab.f_min
    pfit = tab.state_p[..., 0, :]
    has = torch.zeros(caps.shape, dtype=torch.bool, device=caps.device)
    for s in range(n_states):
        fit = tab.state_p[..., s, :] <= caps + FIT_ATOL
        freq = torch.where(fit, tab.state_f[..., s, :], freq)
        pfit = torch.where(fit, tab.state_p[..., s, :], pfit)
        has = has | fit
    q = torch.clamp((caps - tab.idle_w) / tab.span, DUTY_FLOOR, 1.0)
    freq = torch.where(has, freq, tab.f_min)
    duty = torch.where(has, torch.ones_like(q), q)
    power = torch.where(has, pfit, tab.idle_w + q * tab.span)
    return freq, duty, power


def waterfill_plain(tab: StepTables, running: torch.Tensor,
                    budget: torch.Tensor) -> torch.Tensor:
    """Water-fill ``budget`` ``(B, 1)`` over the running lanes (bool
    ``(B, N)``): equal shares, saturated lanes clamp at ``p_max``, the
    surplus re-spreads until absorbed; non-running lanes get the cap
    floor.  Each live pass closes at least one lane, so ``N`` passes
    reach the fixed point; the loop stops early once no row has an open
    lane (every later pass is a no-op)."""
    caps = tab.cap_floor.expand(running.shape)
    open_ = running
    rem = budget
    for _ in range(running.shape[-1]):
        if not bool(open_.any()):
            break
        n_open = open_.sum(dim=-1, keepdim=True)
        live = n_open > 0
        share = torch.where(live, rem / n_open.clamp(min=1), 0.0)
        sat = open_ & (tab.p_max <= share + FIT_ATOL)
        finished = live & ~sat.any(dim=-1, keepdim=True)
        clipped = torch.minimum(torch.maximum(share, tab.cap_floor),
                                tab.p_max)
        caps = torch.where(open_ & finished, clipped, caps)
        caps = torch.where(sat, tab.p_max, caps)
        rem = rem - row_sum(torch.where(sat, tab.p_max, 0.0))
        open_ = open_ & ~sat & ~finished
    return caps


def power_step_plain(tab: StepTables, caps, running, remaining, rho, bound,
                     redistribute: bool = False):
    """Plain PyTorch wave step: caps/running/remaining/rho ``(B, N)``,
    bound ``(B, 1)`` -> ``(rate, p_node, t_fin, eff_caps, p_cluster,
    t_comp)``, lanes ``(B, N)`` and row scalars ``(B, 1)``.  ``running``
    is a float mask (1.0 running / 0.0 not), as the kernel takes it."""
    running = running > 0.5
    if redistribute:
        idle_draw = row_sum(torch.where(running, 0.0, tab.idle_w))
        eff_caps = waterfill_plain(tab, running, bound - idle_draw)
    else:
        eff_caps = caps
    freq, duty, power = translate_caps(tab, eff_caps)
    slowdown = rho * (tab.f_nom / freq) + (1.0 - rho)
    rate = torch.where(running, tab.speed * duty / slowdown, 0.0)
    p_node = torch.where(running, power, tab.idle_w)
    has_rate = rate > 0
    t_fin = torch.where(has_rate,
                        remaining / torch.where(has_rate, rate, 1.0),
                        BIG_TIME)
    p_cluster = row_sum(p_node)
    t_comp = t_fin.amin(dim=-1, keepdim=True)
    return rate, p_node, t_fin, eff_caps, p_cluster, t_comp


# -------------------------------------------------------------- CUDA kernel
def _check_inputs(tab: StepTables, lanes, rows) -> Tuple[int, int, int]:
    """Validate what the kernel takes; returns (B, N, S)."""
    ref = lanes[0]
    if ref.dim() != 2:
        raise ValueError(f"lanes must be (B, N), got {tuple(ref.shape)}")
    b, n = ref.shape
    if not 1 <= n <= MAX_LANES:
        raise ValueError(f"the power_step kernel takes 1..{MAX_LANES} "
                         f"lanes, got {n}")
    if b < 1:
        raise ValueError("the power_step kernel needs at least one row")
    s = tab.state_p.shape[-2]
    stacked = tab.stacked
    want = {"lane": (b, n), "row": (b, 1),
            "state": (b, s, n) if stacked else (s, n),
            "table": (b, n) if stacked else (1, n)}
    checks = ([(t, "lane") for t in lanes] + [(t, "row") for t in rows]
              + [(tab.state_p, "state"), (tab.state_f, "state")]
              + [(t, "table") for t in tab[2:]])
    for t, kind in checks:
        if t.device.type != "cuda" or t.device != ref.device:
            raise ValueError(f"the CUDA kernel needs every tensor on "
                             f"{ref.device} (cuda), got {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"the CUDA kernel takes float32, got "
                             f"{t.dtype}")
        if tuple(t.shape) != want[kind]:
            raise ValueError(f"{kind} tensor of shape {tuple(t.shape)}, "
                             f"expected {want[kind]}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors")
    return b, n, s


def _strides(tab: StepTables, n: int, s: int) -> Tuple[int, int]:
    return (s * n, n) if tab.stacked else (0, 0)


def power_step_cuda(tab: StepTables, caps, running, remaining, rho, bound,
                    redistribute: bool = False):
    """Launch the hand-written kernel (same contract as
    :func:`power_step_plain`; every tensor float32, contiguous, on one
    CUDA device)."""
    from repro_torch.kernels._build import check, load_library

    b, n, s = _check_inputs(tab, (caps, running, remaining, rho), (bound,))
    lib = load_library().lib
    outs = [torch.empty_like(caps) for _ in range(4)]
    rows = [torch.empty_like(bound) for _ in range(2)]
    stride_s, stride_l = _strides(tab, n, s)
    with torch.cuda.device(caps.device):
        stream = torch.cuda.current_stream(caps.device).cuda_stream
        code = lib.repro_power_step(
            *(t.data_ptr() for t in (caps, running, remaining, rho, bound,
                                     *tab, *outs, *rows)),
            b, n, s, stride_s, stride_l, int(bool(redistribute)), stream)
    check(code, "power_step")
    LAUNCHES["power_step"] += 1
    return (*outs, *rows)


def waterfill_cuda(tab: StepTables, running: torch.Tensor,
                   budget: torch.Tensor) -> torch.Tensor:
    """The kernel's water-fill stage alone: running float mask ``(B, N)``,
    budget ``(B, 1)`` -> caps ``(B, N)``."""
    from repro_torch.kernels._build import check, load_library

    b, n, s = _check_inputs(tab, (running,), (budget,))
    lib = load_library().lib
    caps = torch.empty_like(running)
    _, stride_l = _strides(tab, n, s)
    with torch.cuda.device(running.device):
        stream = torch.cuda.current_stream(running.device).cuda_stream
        code = lib.repro_waterfill(
            running.data_ptr(), budget.data_ptr(), tab.cap_floor.data_ptr(),
            tab.p_max.data_ptr(), caps.data_ptr(), b, n, stride_l, stream)
    check(code, "waterfill")
    LAUNCHES["waterfill"] += 1
    return caps


# ------------------------------------------------------- whole-row loop
_P, _LL = ctypes.c_void_p, ctypes.c_longlong

#: The policy tensors each wave mode reads.
_MODE_TENSORS = {"nominal": (), "job_caps": ("caps_job",),
                 "redistribute": (), "heuristic": ("cap", "buf"),
                 "learned": tuple(f"mlp_{k}" for k, _ in MLP_LAYOUT)}

#: The engine's state tensors the loop updates in place, in the order of
#: ``ReproWaveArgs``: name -> (dtype, shape kind).
_WAVE_STATE = {
    "ptr": (torch.int64, "lane"), "running": (torch.bool, "lane"),
    "remaining": (torch.float32, "lane"),
    "completed": (torch.bool, "job"), "start_t": (torch.float32, "job"),
    "end_t": (torch.float32, "job"),
    "row_t": (torch.float32, "row"), "bound": (torch.float32, "row"),
    "sched_idx": (torch.int64, "row"), "done": (torch.bool, "row"),
    "stalled": (torch.bool, "row"), "settled": (torch.bool, "row"),
    "energy": (torch.float32, "row"), "peak": (torch.float32, "row"),
    "over_t": (torch.float32, "row"), "makespan": (torch.float32, "row"),
    "tick_count": (torch.int64, "row"), "steps": (torch.int64, "row"),
}


class _WaveArgs(ctypes.Structure):
    """``ReproWaveArgs`` of ``csrc/power_step.cu``, field for field."""

    _fields_ = (
        [(name, _P) for name in StepTables._fields]
        + [("stride_s", _LL), ("stride_l", _LL),
           ("node_seq", _P), ("stride_seq", _LL),
           ("deps", _P), ("stride_deps", _LL),
           ("work", _P), ("rho", _P), ("stride_job", _LL),
           ("n_active", _P), ("sched_t", _P), ("sched_w", _P),
           ("caps_job", _P), ("cap", _P), ("ring", _P), ("mlp", _P)]
        + [(name, _P) for name in _WAVE_STATE]
        + [("iters", _P), ("max_steps", _LL), ("dt", ctypes.c_float)]
        + [(name, ctypes.c_int)
           for name in ("B", "N", "S", "K", "J", "D", "T", "depth", "mode")])


def _need(t: torch.Tensor, name: str, dtype, shape, device,
          shared_rows: bool = False) -> None:
    """Raise unless ``t`` is what the loop kernel reads: on ``device``,
    of ``dtype`` and ``shape``, each row contiguous, rows packed (or, with
    ``shared_rows``, one row expanded over all with stride 0)."""
    if t.device.type != "cuda" or t.device != device:
        raise ValueError(f"the wave_run kernel needs every tensor on "
                         f"{device} (cuda): {name} is on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: the wave_run kernel takes {dtype}, got "
                         f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} of shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    row = t[0]
    packed = t.stride(0) == max(row.numel(), 1) or \
        (shared_rows and t.stride(0) == 0)
    if not (row.is_contiguous() and packed):
        raise ValueError(f"{name}: the wave_run kernel takes contiguous "
                         f"rows" + (" (or one row shared with stride 0)"
                                    if shared_rows else ""))


def _check_wave_inputs(ctx, st, pol, sched_t, sched_w, mode):
    """Validate what the loop kernel takes; returns its dimensions."""
    if mode not in WAVE_MODES:
        raise ValueError(f"unknown wave mode {mode!r}; expected one of "
                         f"{sorted(WAVE_MODES)}")
    missing = [key for key in _MODE_TENSORS[mode] if key not in pol]
    if missing:
        raise ValueError(f"wave mode {mode!r} needs the policy tensors "
                         f"{missing}")
    if st.ptr.dim() != 2 or st.completed.dim() != 2:
        raise ValueError("the wave_run kernel takes (B, N) lanes and "
                         "(B, J+1) jobs")
    b, n = st.ptr.shape
    j1 = st.completed.shape[1]
    if not 1 <= n <= MAX_LANES:
        raise ValueError(f"the wave_run kernel takes 1..{MAX_LANES} lanes, "
                         f"got {n}")
    if b < 1 or j1 < 1:
        raise ValueError("the wave_run kernel needs at least one row and "
                         "the sentinel job slot")
    dev = st.ptr.device
    shape = {"lane": (b, n), "job": (b, j1), "row": (b,)}
    for name, (dtype, kind) in _WAVE_STATE.items():
        _need(getattr(st, name), name, dtype, shape[kind], dev)
    tab = ctx.tab
    s = tab.state_p.shape[-2]
    for name in ("state_p", "state_f"):
        _need(getattr(tab, name), name, torch.float32,
              (b, s, n) if tab.stacked else (s, n), dev)
    for name in StepTables._fields[2:]:
        _need(getattr(tab, name), name, torch.float32,
              (b, n) if tab.stacked else (1, n), dev)
    k, d = ctx.node_seq.shape[-1], ctx.deps_pad.shape[-1]
    _need(ctx.node_seq, "node_seq", torch.int32, (b, n, k), dev, True)
    _need(ctx.deps_pad, "deps_pad", torch.int32, (b, j1, d), dev, True)
    _need(ctx.work_pad, "work_pad", torch.float32, (b, j1), dev, True)
    _need(ctx.rho_pad, "rho_pad", torch.float32, (b, j1), dev, True)
    if ctx.work_pad.stride(0) != ctx.rho_pad.stride(0):
        raise ValueError("work_pad and rho_pad must share one row layout")
    _need(ctx.n_active, "n_active", torch.int32, (b,), dev)
    t_cols = sched_t.shape[-1]
    _need(sched_t, "sched_t", torch.float32, (b, t_cols), dev)
    _need(sched_w, "sched_w", torch.float32, (b, t_cols), dev)
    depth = 0
    if mode == "job_caps":
        _need(pol["caps_job"], "caps_job", torch.float32, (b, j1), dev)
    elif mode == "heuristic":
        depth = pol["buf"].shape[1] if pol["buf"].dim() == 3 else 0
        _need(pol["cap"], "cap", torch.float32, (b, n), dev)
        _need(pol["buf"], "buf", torch.float32, (b, depth, n), dev)
        if depth < 1:
            raise ValueError("the heuristic's ring needs depth >= 1")
    elif mode == "learned":
        for key, shape in MLP_LAYOUT:
            t = pol[f"mlp_{key}"]
            if t.device != dev or t.dtype != torch.float32 or \
                    tuple(t.shape) != shape:
                raise ValueError(f"mlp_{key}: the wave_run kernel takes "
                                 f"float32 {shape} on {dev}, got "
                                 f"{t.dtype} {tuple(t.shape)} on "
                                 f"{t.device}")
    return b, n, s, k, j1 - 1, d, t_cols, depth


def wave_run_cuda(ctx, st, pol, sched_t, sched_w, *, mode: str, dt: float,
                  max_steps: int) -> torch.Tensor:
    """Run every row of a batch through its whole wave loop in one launch.

    ``ctx`` and ``st`` are the engine's geometry and state
    (:class:`~repro_torch.backends.engine.Ctx` with int32 ``node_seq`` /
    ``deps_pad`` / ``n_active``, and
    :class:`~repro_torch.backends.engine.State`), ``pol`` the policy's
    tensors, ``sched_t``/``sched_w`` the ``(B, T)`` bound schedules and
    ``mode`` a key of :data:`WAVE_MODES`.  The state (and the heuristic's
    ``cap``/``buf``) is updated in place to where the engine's lockstep
    loop leaves it; returns each row's loop-iteration count ``(B,)``."""
    from repro_torch.kernels._build import check, load_library

    b, n, s, k, j, d, t_cols, depth = _check_wave_inputs(
        ctx, st, pol, sched_t, sched_w, mode)
    lib = load_library().lib
    iters = torch.zeros(b, dtype=torch.int64, device=st.ptr.device)
    stride_s, stride_l = _strides(ctx.tab, n, s)
    heur = mode == "heuristic"
    mlp = None
    if mode == "learned":
        # one packed buffer, the layout the kernel reads
        mlp = torch.cat([pol[f"mlp_{key}"].reshape(-1)
                         for key, _ in MLP_LAYOUT])
    args = _WaveArgs(
        *(t.data_ptr() for t in ctx.tab), stride_s, stride_l,
        ctx.node_seq.data_ptr(), ctx.node_seq.stride(0),
        ctx.deps_pad.data_ptr(), ctx.deps_pad.stride(0),
        ctx.work_pad.data_ptr(), ctx.rho_pad.data_ptr(),
        ctx.work_pad.stride(0), ctx.n_active.data_ptr(),
        sched_t.data_ptr(), sched_w.data_ptr(),
        pol["caps_job"].data_ptr() if mode == "job_caps" else None,
        pol["cap"].data_ptr() if heur else None,
        pol["buf"].data_ptr() if heur else None,
        mlp.data_ptr() if mlp is not None else None,
        *(getattr(st, name).data_ptr() for name in _WAVE_STATE),
        iters.data_ptr(), int(max_steps), float(dt),
        b, n, s, k, j, d, t_cols, depth, WAVE_MODES[mode])
    with torch.cuda.device(st.ptr.device):
        stream = torch.cuda.current_stream(st.ptr.device).cuda_stream
        code = lib.repro_wave_run(ctypes.addressof(args), stream)
    check(code, "wave_run")
    LAUNCHES["wave_run"] += 1
    return iters


# --------------------------------------------------------------- dispatch
def resolve_impl(impl: Optional[str], like: torch.Tensor) -> str:
    """``None`` picks by device: the kernel for CUDA tensors, the plain
    version for CPU tensors.  ``"plain"`` / ``"cuda"`` force one."""
    if impl is None:
        return "cuda" if like.is_cuda else "plain"
    if impl not in ("plain", "cuda"):
        raise ValueError(f"unknown kernel impl {impl!r}")
    return impl


def power_step(tab: StepTables, caps, running, remaining, rho, bound,
               redistribute: bool = False, impl: Optional[str] = None):
    """Dispatch one fused wave step (see :func:`resolve_impl`)."""
    if resolve_impl(impl, caps) == "plain":
        return power_step_plain(tab, caps, running, remaining, rho, bound,
                                redistribute)
    return power_step_cuda(tab, caps, running, remaining, rho, bound,
                           redistribute)


def waterfill(tab: StepTables, running: torch.Tensor, budget: torch.Tensor,
              impl: Optional[str] = None) -> torch.Tensor:
    """Dispatch the water-fill stage; ``running`` is a float mask."""
    if resolve_impl(impl, running) == "plain":
        return waterfill_plain(tab, running > 0.5, budget)
    return waterfill_cuda(tab, running, budget)
