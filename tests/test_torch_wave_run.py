"""The engine's three paths and the whole-row kernel's wrapper, on the CPU.

``TorchBatchSimulator(impl=...)`` picks ``"plain"`` (the lockstep loop
with the plain versions), ``"step"`` (the lockstep loop with one
``power_step`` launch a wave) or ``"cuda"`` (one ``wave_run`` launch for
the whole batch, the policy's cap rule inside the kernel).  Here: how
``impl`` resolves by device and by the policy's declared ``kernel_mode``,
the wrapper's input checks (which raise before any library is loaded),
the ctypes mirror of the kernel's argument struct, and the plain path's
wave counts against the JAX reference engine, which the kernel's loop
counts are held to on the card (``tests/test_torch_kernel_cuda.py``).
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.backends.engine import (ENGINE_IMPLS, TorchBatchSimulator,
                                         resolve_impl)
from repro_torch.backends.policies import (TorchEqualShare,
                                           TorchOnlineHeuristic, TorchPolicy,
                                           get_torch_policy, kernel_mode,
                                           torch_policies)
from repro_torch.core.power import (heterogeneous_cluster,
                                    homogeneous_cluster,
                                    max_useful_cluster_bound,
                                    min_feasible_cluster_bound)
from repro_torch.core.workloads import is_like, listing2_graph
from repro_torch.kernels import _build
from repro_torch.kernels import power_step as ps

MODES = {"equal-share": "nominal", "ilp": "job_caps",
         "ilp-makespan": "job_caps", "oracle": "redistribute",
         "heuristic": "heuristic"}


class HalfShare(TorchEqualShare):
    """Changes equal-share's caps, so equal-share's mode no longer fits."""

    name = "half-share"

    @staticmethod
    def caps_fn(ctx, st, pol):
        return 0.5 * TorchPolicy.caps_fn(ctx, st, pol)


def _policy(name):
    if name == "custom":
        return TorchPolicy()
    if name == "half-share":
        return HalfShare()
    return get_torch_policy(name)


@pytest.mark.parametrize("impl,device,policy,want", [
    (None, "cpu", "equal-share", "plain"),
    (None, "cpu", "custom", "plain"),
    ("plain", "cpu", "heuristic", "plain"),
    (None, "cuda", "equal-share", "cuda"),
    (None, "cuda", "ilp", "cuda"),
    (None, "cuda", "oracle", "cuda"),
    (None, "cuda", "heuristic", "cuda"),
    ("cuda", "cuda", "ilp-makespan", "cuda"),
    ("step", "cuda", "heuristic", "step"),
    ("plain", "cuda", "oracle", "plain"),
    (None, "cuda", "custom", "step"),
    (None, "cuda", "half-share", "step"),
    ("step", "cuda", "half-share", "step"),
])
def test_impl_resolution(impl, device, policy, want):
    """``None`` picks by device and by the policy's capability: the plain
    path on the CPU; on the card the kernel loop for a policy with a mode
    and the per-wave path for one without."""
    assert want in ENGINE_IMPLS
    assert resolve_impl(impl, torch.device(device), _policy(policy)) == want


@pytest.mark.parametrize("impl,device,policy,match", [
    ("step", "cpu", "equal-share", "needs a CUDA device"),
    ("cuda", "cpu", "heuristic", "needs a CUDA device"),
    ("cuda", "cuda", "custom", "kernel_mode"),
    ("cuda", "cuda", "half-share", "kernel_mode"),
    ("pallas", "cpu", "equal-share", "unknown engine impl"),
])
def test_impl_resolution_raises(impl, device, policy, match):
    """Nothing falls back: the kernel paths off the card, the kernel loop
    for a policy without a mode, and unknown names raise."""
    with pytest.raises(ValueError, match=match):
        resolve_impl(impl, torch.device(device), _policy(policy))


def test_simulator_resolves_impl_at_construction():
    graph, specs = listing2_graph(), homogeneous_cluster(3)
    sim = TorchBatchSimulator(graph, specs, [6.0], device="cpu")
    assert sim.impl == "plain"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TorchBatchSimulator(graph, specs, [6.0], "oracle", device="cpu",
                            impl="cuda")


@pytest.mark.parametrize("name", sorted(MODES))
def test_registry_policy_declares_its_kernel_mode(name):
    """Each registry policy names its cap rule for the kernel loop, and
    the rule agrees with the flags the lockstep loop reads."""
    policy = get_torch_policy(name)
    mode = kernel_mode(policy)
    assert mode == MODES[name] and mode in ps.WAVE_MODES
    assert "kernel_mode" in vars(type(policy))
    assert (mode == "redistribute") == policy.redistribute
    assert (mode == "heuristic") == policy.wants_ticks


def test_every_registered_policy_has_a_mode_and_subclasses_do_not():
    """Aliases included, every registry key resolves to a policy with a
    mode of the kernel (``learned`` too); a mode is not inherited, so a
    subclass that changes the cap functions (or the base class) has
    none."""
    for key in torch_policies():
        mode = kernel_mode(get_torch_policy(key))
        assert mode in ps.WAVE_MODES, key
    assert kernel_mode(HalfShare()) is None
    assert kernel_mode(TorchPolicy()) is None
    assert HalfShare.kernel_mode == "nominal"      # the attribute is there


def test_cpu_run_reports_the_plain_path():
    graph, specs = listing2_graph(), homogeneous_cluster(3)
    sim = TorchBatchSimulator(graph, specs, [6.0, 12.0], "oracle",
                              device="cpu", check_every=8)
    sim.run()
    st = sim.stats
    assert st.path == "plain" and st.kernel_ms is None
    assert st.waves % 8 == 0 and st.host_syncs == st.waves // 8 + 1
    assert 0 < st.row_waves <= 2 * st.waves


# ---------------------------------------------------------- the wrapper
def _heuristic_case():
    """The engine's geometry, state and heuristic tensors for Listing 2
    at two bounds, as the kernel path builds them (int32 geometry)."""
    sim = TorchBatchSimulator(listing2_graph(), homogeneous_cluster(3),
                              [6.0, 12.0], "heuristic", device="cpu")
    sim.impl = "cuda"           # build what the kernel path would
    pol = {k: sim._tensor(v, torch.float32)
           for k, v in sim.policy.init_state(sim).items()}
    sched = torch.full((2, 1), ps.BIG_TIME)
    return sim._ctx(), sim._state0(), pol, sched


def _no_library():
    raise AssertionError("the checks must raise before the library loads")


@pytest.mark.parametrize("case,match", [
    ("mode", "unknown wave mode"),
    ("missing cap", r"policy tensors \['cap'\]"),
    ("missing caps_job", r"policy tensors \['caps_job'\]"),
    ("lanes", "1..256 lanes"),
    ("rank", r"\(B, N\) lanes"),
    ("device", "cuda"),
])
def test_wave_run_checks_inputs_before_loading(monkeypatch, case, match):
    monkeypatch.setattr(_build, "load_library", _no_library)
    ctx, st, pol, sched = _heuristic_case()
    mode = "heuristic"
    if case == "mode":
        mode = "tick"
    elif case == "missing cap":
        pol = {"buf": pol["buf"]}
    elif case == "missing caps_job":
        mode = "job_caps"
    elif case == "lanes":
        st = dataclasses.replace(st, ptr=torch.zeros(2, 300,
                                                     dtype=torch.int64))
    elif case == "rank":
        st = dataclasses.replace(st, ptr=st.ptr[0])
    before = dict(ps.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        ps.wave_run_cuda(ctx, st, pol, sched, torch.zeros_like(sched),
                         mode=mode, dt=0.05, max_steps=100)
    assert ps.LAUNCHES == before


_C_TYPES = {"ptr": ps.ctypes.c_void_p, "long long": ps.ctypes.c_longlong,
            "float": ps.ctypes.c_float, "int": ps.ctypes.c_int}


def test_wave_args_mirror_the_c_struct():
    """``_WaveArgs`` names the fields of ``ReproWaveArgs`` in
    ``csrc/power_step.cu`` in order, each with a ctypes type of the C
    type's size."""
    src = (Path(ps.__file__).parent / "csrc" / "power_step.cu").read_text()
    body = re.search(r"struct ReproWaveArgs \{(.*?)\n\};", src, re.S)[1]
    fields = []
    for line in body.splitlines():
        decl = line.split("//")[0].strip().rstrip(";")
        if not decl:
            continue
        m = re.match(r"(?:const )?(unsigned char|long long|float|int)"
                     r"\s*(\*?)\s*(.*)", decl)
        kind = "ptr" if m[2] else m[1]
        fields += [(name.strip(), _C_TYPES[kind])
                   for name in m[3].split(",")]
    assert [(n, t) for n, t in ps._WaveArgs._fields_] == fields
    assert len(fields) == 55


# ------------------------------------------------ the plain path's waves
def test_heuristic_tick_sums_idle_in_the_kernel_order():
    """The tick's budget is the bound minus the idle draw summed as the
    kernel's warp sums it (``row_sum``), which can differ from
    ``torch.sum`` in the last bit."""
    rng = np.random.default_rng(0)
    b, n = 64, 70
    sim = TorchBatchSimulator(is_like(n, "A"), heterogeneous_cluster(n),
                              rng.uniform(300.0, 500.0, b), "heuristic",
                              device="cpu")
    ctx, st = sim._ctx(), sim._state0()
    st.running = torch.from_numpy(rng.random((b, n)) < 0.5)
    pol = {k: sim._tensor(v, torch.float32)
           for k, v in sim.policy.init_state(sim).items()}
    due = torch.ones(b, dtype=torch.bool)
    out = TorchOnlineHeuristic.tick_fn(ctx, st, pol, due)
    idle = torch.where(st.running, 0.0, ctx.tab.idle_w)
    budget = st.bound.unsqueeze(-1) - ps.row_sum(idle)
    want = ps.waterfill_plain(ctx.tab, st.running, budget)
    assert torch.equal(out["buf"][:, 0], want)
    # the order matters on these rows: torch.sum rounds otherwise
    assert not torch.equal(ps.row_sum(idle), idle.sum(-1, keepdim=True))


@pytest.mark.parametrize("workload", ["listing2", "is4"])
@pytest.mark.parametrize("policy", ["equal-share", "oracle", "heuristic"])
def test_row_waves_match_reference(workload, policy):
    """Each row of the plain path walks the reference engine's waves: the
    waves summed over the rows equal the JAX engine's per-row steps
    summed (the kernel loop's counts are held to the plain path's on the
    card)."""
    pytest.importorskip("jax")
    from repro.backends.jax import JaxBatchSimulator
    from repro.core import power as ref_power
    from repro.core import workloads as ref_workloads

    from repro_torch.convert import from_reference

    if workload == "listing2":
        graph = ref_workloads.listing2_graph()
        specs = ref_power.homogeneous_cluster(3)
        bounds = [2.5, 6.0, 12.0]
    else:
        graph = ref_workloads.is_like(4, "A")
        specs = ref_power.heterogeneous_cluster(4)
        lo = min_feasible_cluster_bound(from_reference(specs))
        hi = max_useful_cluster_bound(from_reference(specs))
        bounds = [lo + f * (hi - lo) for f in (0.6, 0.9)]
    pending = JaxBatchSimulator(graph, specs, bounds, policy).dispatch()
    ref_steps = np.asarray(pending.out["steps"])[:len(bounds)]
    sim = TorchBatchSimulator(from_reference(graph), from_reference(specs),
                              bounds, policy, device="cpu")
    sim.run()
    assert sim.stats.row_waves == int(ref_steps.sum())
