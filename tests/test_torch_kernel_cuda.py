"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card: ``power_step`` (with ``waterfill``, and the whole-row wave loop
``wave_run`` against the engine's plain and per-wave paths), ``rmsnorm``,
``flash_attention`` and ``ssm_scan``, the backward kernels
(``rmsnorm_bwd``, ``flash_attention_bwd`` and ``ssm_scan_bwd`` in both
variants) and one training loss and backward of each family's
smoke model on the card.  Every test
here needs an NVIDIA
GPU with ``nvcc`` and skips elsewhere; the file imports neither ``jax``
nor ``repro``, so it runs on the GPU machine as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_cuda.py
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.backends.engine import TorchBatchSimulator
from repro_torch.backends.policies import TorchEqualShare, TorchPolicy
from repro_torch.core.graph import JobDependencyGraph
from repro_torch.core.ilp import build_makespan_milp, solve_paper_ilp
from repro_torch.core.power import (heterogeneous_cluster,
                                    homogeneous_cluster, lut_table,
                                    max_useful_cluster_bound,
                                    min_feasible_cluster_bound,
                                    stack_lut_tables)
from repro_torch.core.workloads import is_like, listing2_graph, mixed_members
from repro_torch.configs import get_smoke
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import power_step as ps
from repro_torch.kernels import rmsnorm as rn
from repro_torch.kernels import ssm_scan as ss
from repro_torch.kernels._build import check, load_library
from repro_torch.models import forward, init_params

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with nvcc (run on the card)")
    return torch.device("cuda")


def _stacked_inputs(n, rows, seed, device):
    """Per-row clusters of 1..n nodes (phantom lanes past each) and
    random wave inputs, from a numpy seed."""
    rng = np.random.default_rng(seed)
    table = stack_lut_tables(
        [lut_table(heterogeneous_cluster(int(rng.integers(1, n + 1)),
                                         seed=int(rng.integers(1 << 16))))
         for _ in range(rows)], n, 10)
    real = table.p_max > 0
    f32 = lambda a: torch.tensor(a, dtype=torch.float32,  # noqa: E731
                                 device=device)
    bound = rng.uniform(table.idle_w.sum(-1), table.p_max.sum(-1))[:, None]
    args = [f32(rng.uniform(0.2, 10.0, (rows, n))),
            f32((rng.random((rows, n)) < 0.7) & real),
            f32(rng.uniform(0.0, 50.0, (rows, n))),
            f32(rng.uniform(0.1, 1.0, (rows, n))), f32(bound)]
    return ps.step_tables(table, device), args


@pytest.mark.parametrize("redistribute", [False, True])
@pytest.mark.parametrize("n", [3, 33, 200])
def test_kernel_matches_plain(cuda_device, n, redistribute):
    tab, args = _stacked_inputs(n, 512, n, cuda_device)
    before = ps.LAUNCHES["power_step"]
    got = ps.power_step(tab, *args, redistribute=redistribute)
    torch.cuda.synchronize()
    assert ps.LAUNCHES["power_step"] == before + 1
    want = ps.power_step(tab, *args, redistribute=redistribute,
                         impl="plain")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    fill = ps.waterfill(tab, args[1], args[4])
    torch.testing.assert_close(
        fill, ps.waterfill(tab, args[1], args[4], impl="plain"),
        rtol=1e-5, atol=1e-5)


def test_kernel_rejects_what_it_cannot_take(cuda_device):
    tab, args = _stacked_inputs(300, 4, 0, cuda_device)
    with pytest.raises(ValueError, match="lanes"):
        ps.power_step(tab, *args)
    tab, args = _stacked_inputs(8, 4, 0, cuda_device)
    with pytest.raises(ValueError, match="float32"):
        ps.power_step(tab, args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        ps.power_step(tab, args[0].t().contiguous().t(), *args[1:])


@pytest.mark.parametrize("policy", ["equal-share", "oracle", "heuristic"])
def test_engine_on_card_matches_cpu(cuda_device, policy):
    """The kernel engine on the card against the plain engine on the
    CPU, on the padded mixed-family batch with bound schedules."""
    items, bounds, scheds = [], [], []
    for _name, graph, specs, steps in mixed_members(seed=0):
        items.append((graph, specs))
        bounds.append(0.5 * sum(s.lut.p_max for s in specs))
        scheds.append(tuple((t, f * bounds[-1]) for t, f in steps))
    runs = [TorchBatchSimulator.padded(items, bounds, policy,
                                       bound_schedules=scheds,
                                       device=dev).run()
            for dev in (cuda_device, "cpu")]
    for a, b in zip(*runs):
        for f in ("makespan", "energy_j", "peak_power_w",
                  "over_budget_time"):
            assert getattr(a, f) == pytest.approx(getattr(b, f), rel=1e-5,
                                                  abs=1e-9)
        assert a.job_ends.keys() == b.job_ends.keys()


def test_default_device_is_the_card(cuda_device):
    sim = TorchBatchSimulator(listing2_graph(),
                              heterogeneous_cluster(3), [6.0])
    assert sim.device.type == "cuda" and sim.impl == "cuda"
    assert sim.run()[0].makespan > 0


# ------------------------------------------------------ whole-row loop
#: the chip_smoke bar: rtol 1e-5 per row on makespan / energy / peak /
#: over-budget time, the same jobs completed; the kernel rounds as the
#: plain path does, so the max abs diff is expected to be 0.0
WAVE_RTOL = 1e-5
POLICIES = ("equal-share", "ilp", "ilp-makespan", "oracle", "heuristic")


def _assignments(policy, items, bounds):
    """Paper / makespan ILP caps solved once (5 s cap a solve) and given
    to every path; the other policies take no arguments."""
    if not policy.startswith("ilp"):
        return {}
    solver = (build_makespan_milp if policy == "ilp-makespan"
              else solve_paper_ilp)
    return {"assignments": [solver(g, sp, b, time_limit=5.0)
                            for (g, sp), b in zip(items, bounds)]}


def _max_abs_diff(got, want):
    """Hold the results at WAVE_RTOL per row; the max abs diff over the
    row scalars and every job's start and end stamp."""
    worst = 0.0
    for a, b in zip(got, want):
        for f in ("makespan", "energy_j", "peak_power_w",
                  "over_budget_time"):
            assert getattr(a, f) == pytest.approx(
                getattr(b, f), rel=WAVE_RTOL, abs=1e-9), f
            worst = max(worst, abs(getattr(a, f) - getattr(b, f)))
        assert a.job_ends.keys() == b.job_ends.keys()
        assert a.job_starts.keys() == b.job_starts.keys()
        for k in b.job_ends:
            worst = max(worst, abs(a.job_ends[k] - b.job_ends[k]),
                        abs(a.job_starts[k] - b.job_starts[k]))
    return worst


def _cuda_vs_plain(make):
    """Run ``make(impl)`` on the kernel path (one wave_run launch, no
    per-wave launch) and on the plain path with liveness tested every
    iteration; the loop counts agree and the results are held at the
    chip_smoke bar.  Returns the kernel's simulator and the max abs
    diff."""
    before = dict(ps.LAUNCHES)
    sim = make("cuda", check_every=64)
    got = sim.run()
    assert {k: ps.LAUNCHES[k] - before[k] for k in before} == \
        {"power_step": 0, "waterfill": 0, "wave_run": 1}
    plain = make("plain", check_every=1)
    want = plain.run()
    diff = _max_abs_diff(got, want)
    print(f"max abs diff vs plain: {diff}")
    assert sim.stats.path == "cuda" and plain.stats.path == "plain"
    assert sim.stats.waves == plain.stats.waves
    assert sim.stats.row_waves == plain.stats.row_waves
    return sim, diff


@pytest.mark.parametrize("workload", ["listing2", "is4"])
@pytest.mark.parametrize("policy", POLICIES)
def test_wave_run_matches_plain_shared(cuda_device, workload, policy):
    """Listing 2 on three nodes and the IS analogue on a 4-node mixed
    cluster (ragged LUTs), one graph shared by every row."""
    if workload == "listing2":
        graph, specs = listing2_graph(), homogeneous_cluster(3)
        bounds = [2.5, 6.0, 12.0]
    else:
        graph, specs = is_like(4, "A"), heterogeneous_cluster(4)
        lo = min_feasible_cluster_bound(specs)
        hi = max_useful_cluster_bound(specs)
        bounds = [lo + f * (hi - lo) for f in (0.6, 0.9)]
    kw = _assignments(policy, [(graph, specs)] * len(bounds), bounds)
    _cuda_vs_plain(lambda impl, **k: TorchBatchSimulator(
        graph, specs, bounds, policy, impl=impl, **kw, **k))


@pytest.mark.parametrize("policy", POLICIES)
def test_wave_run_matches_plain_padded(cuda_device, policy):
    """The stacked mixed-family batch (phantom lanes and job slots) with
    bound schedules that drop and recover mid-run; the ILP policies on
    the members whose MILPs solve in well under a second."""
    fast = ("l2", "l2r", "layered5", "forkjoin4")
    items, bounds, scheds = [], [], []
    for name, graph, specs, steps in mixed_members(seed=0):
        if policy.startswith("ilp") and name not in fast:
            continue
        lo = min_feasible_cluster_bound(specs)
        hi = max_useful_cluster_bound(specs)
        for frac in (0.15, 0.4, 0.8):
            items.append((graph, specs))
            bounds.append(lo + frac * (hi - lo))
            scheds.append(tuple((t, f * bounds[-1]) for t, f in steps))
    kw = _assignments(policy, items, bounds)
    _cuda_vs_plain(lambda impl, **k: TorchBatchSimulator.padded(
        items, bounds, policy, bound_schedules=scheds, impl=impl, **kw,
        **k))


def test_wave_run_deadlock_raises_like_plain(cuda_device):
    """Each lane's first job waits on the other lane's second job: the
    kernel path raises the plain path's deadlock error."""
    g = JobDependencyGraph()
    g.add(0, 1, 5.0, deps=[(1, 2)])
    g.add(0, 2, 5.0)
    g.add(1, 1, 5.0, deps=[(0, 2)])
    g.add(1, 2, 5.0)
    for policy in ("equal-share", "heuristic"):
        errors = []
        for impl in ("cuda", "plain"):
            with pytest.raises(RuntimeError, match="deadlock") as err:
                TorchBatchSimulator(g, homogeneous_cluster(2), [6.0], policy,
                                    impl=impl).run()
            errors.append(str(err.value))
        assert errors[0] == errors[1]


def test_wave_run_max_steps_raises(cuda_device):
    """A row out of max_steps raises on the kernel path as on the plain
    one."""
    for impl in ("cuda", "plain"):
        with pytest.raises(RuntimeError, match="max steps"):
            TorchBatchSimulator(listing2_graph(), heterogeneous_cluster(3),
                                [6.0, 12.0], "heuristic", max_steps=50,
                                impl=impl).run()


def test_wave_run_stats(cuda_device):
    """One launch; ``waves`` is the longest row's loop count, which the
    per-wave path rounds up to a multiple of check_every; the kernel's
    time is measured; the per-wave path's results agree."""
    graph, specs = listing2_graph(), heterogeneous_cluster(3)
    bounds = [3.0, 6.0, 12.0]
    before = dict(ps.LAUNCHES)
    sim = TorchBatchSimulator(graph, specs, bounds, "heuristic")
    got = sim.run()
    assert ps.LAUNCHES["wave_run"] == before["wave_run"] + 1
    assert sim.stats.path == "cuda" and sim.stats.host_syncs == 1
    assert sim.stats.kernel_ms > 0
    step = TorchBatchSimulator(graph, specs, bounds, "heuristic",
                               impl="step", check_every=64)
    want = step.run()
    assert step.stats.path == "step" and step.stats.kernel_ms is None
    assert step.stats.waves == -(-sim.stats.waves // 64) * 64
    assert ps.LAUNCHES["power_step"] - before["power_step"] == \
        step.stats.waves
    assert sim.stats.row_waves == step.stats.row_waves
    print(f"max abs diff vs step: {_max_abs_diff(got, want)}")


def test_custom_policy_runs_the_step_path(cuda_device):
    """A policy that declares no kernel mode (here a subclass that
    changes the caps) runs on the per-wave path by default, and asking
    for the kernel path raises."""

    class HalfShare(TorchEqualShare):
        @staticmethod
        def caps_fn(ctx, st, pol):
            return 0.5 * TorchPolicy.caps_fn(ctx, st, pol)

    graph, specs = listing2_graph(), homogeneous_cluster(3)
    before = dict(ps.LAUNCHES)
    sim = TorchBatchSimulator(graph, specs, [12.0], HalfShare())
    res = sim.run()
    assert sim.stats.path == "step"
    assert ps.LAUNCHES["wave_run"] == before["wave_run"]
    assert ps.LAUNCHES["power_step"] - before["power_step"] == \
        sim.stats.waves
    plain = TorchBatchSimulator(graph, specs, [12.0], HalfShare(),
                                impl="plain").run()
    assert _max_abs_diff(res, plain) <= 1e-4
    with pytest.raises(ValueError, match="kernel_mode"):
        TorchBatchSimulator(graph, specs, [12.0], HalfShare(), impl="cuda")


def test_wave_run_rejects_what_it_cannot_take(cuda_device):
    """The wrapper's checks on card tensors: int64 geometry, a missing
    policy tensor, a row layout the kernel cannot stride."""
    sim = TorchBatchSimulator(listing2_graph(), homogeneous_cluster(3),
                              [6.0, 12.0], "heuristic")
    ctx, st = sim._ctx(), sim._state0()
    pol = {k: sim._tensor(v, torch.float32)
           for k, v in sim.policy.init_state(sim).items()}
    sched = torch.full((2, 1), ps.BIG_TIME, device=cuda_device)
    run = lambda c, s, p: ps.wave_run_cuda(  # noqa: E731
        c, s, p, sched, torch.zeros_like(sched), mode="heuristic", dt=0.05,
        max_steps=1_000_000)
    before = dict(ps.LAUNCHES)
    with pytest.raises(ValueError, match="int32"):
        run(ctx._replace(node_seq=ctx.node_seq.long()), st, pol)
    with pytest.raises(ValueError, match="policy tensors"):
        run(ctx, st, {"cap": pol["cap"]})
    with pytest.raises(ValueError, match="contiguous rows"):
        run(ctx, st, {**pol, "cap": pol["cap"].t().contiguous().t()})
    assert ps.LAUNCHES == before
    iters = run(ctx, st, pol)
    assert ps.LAUNCHES["wave_run"] == before["wave_run"] + 1
    assert int(iters.max()) > 0 and bool(st.done.all())


# ------------------------------------------------------------ LM kernels
#: kernel vs plain: the rmsnorm kernel sums in the plain version's order
#: (measured bit for bit on the card, and held so below); flash
#: attention's products run in another order than cuBLAS's, so fp32
#: agrees to rounding and bf16 to a flipped rounding of p or of the output
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
#: The tensor-core flash backward against its bf16-operand twin, besides
#: TOL: the largest 64-row tile's normwise distance, as chip_smoke.py
#: holds it (PERF.md gives the readings it was set from).
TC_BWD_TILE_NORMWISE = 2e-3


def _step_tiles(got, want, axis, steps=64):
    """Largest ||got - want|| / ||want|| over the tiles of ``steps`` steps
    (axis ``axis``; the last tile ragged) of each leading index, in
    float64."""
    lead = int(np.prod(want.shape[:axis]))
    s = want.shape[axis]
    pad = -s % steps
    tiles = []
    for t in (got, want):
        t = t.double().reshape(lead, s, -1)
        t = torch.nn.functional.pad(t, (0, 0, 0, pad))
        tiles.append(t.reshape(lead, (s + pad) // steps, -1))
    g, w = tiles
    return float(((g - w).norm(dim=-1)
                  / w.norm(dim=-1).clamp_min(1e-300)).max())


@pytest.mark.parametrize("layer_form", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4096), (1000, 4096), (3, 5, 96),
                                   (2, 300), (8, 2560), (8, 5120),
                                   (4, 1001)])
def test_rmsnorm_kernel_matches_plain(cuda_device, shape, dtype, layer_form):
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    g = (1 + torch.randn(shape[-1], generator=gen,
                         device=cuda_device)).to(dtype)
    before = rn.LAUNCHES["rmsnorm"]
    got = rn.rmsnorm(x, g, layer_form=layer_form)
    torch.cuda.synchronize()
    assert rn.LAUNCHES["rmsnorm"] == before + 1
    want = rn.rmsnorm(x, g, layer_form=layer_form, impl="plain")
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,offset", [(4096, 1), (4096, 3), (20000, 0),
                                      (8192, 0)])
def test_rmsnorm_kernel_strided_rows(cuda_device, d, offset, dtype):
    """Rows off the vector path (x off its 16-byte alignment, more chunks
    a thread than registers hold) and the widest fp32 row on it: bit for
    bit the plain version, in both forms."""
    gen = torch.Generator(device=cuda_device).manual_seed(d + offset)
    x = torch.randn(3 * d + offset, generator=gen, device=cuda_device)
    x = x.to(dtype)[offset:].view(3, d)
    g = (1 + torch.randn(d, generator=gen, device=cuda_device)).to(dtype)
    for layer_form in (False, True):
        got = rn.rmsnorm(x, g, layer_form=layer_form)
        want = rn.rmsnorm(x, g, layer_form=layer_form, impl="plain")
        assert torch.equal(got, want)


def test_rmsnorm_on_a_side_stream(cuda_device):
    """A launch on a non-default stream writes what the default stream's
    does: the wrapper launches on PyTorch's current stream."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn(8, 4096, generator=gen, device=cuda_device).bfloat16()
    g = (1 + torch.randn(4096, generator=gen, device=cuda_device)).bfloat16()
    want = rn.rmsnorm(x, g, layer_form=True)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = rn.rmsnorm(x, g, layer_form=True)
        x.add_(1.0)          # ordered after the launch on the same stream
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_rmsnorm_captured_in_a_cuda_graph(cuda_device):
    """One rmsnorm captured in a CUDA graph and replayed on new input
    gives the eager result: the launch path neither syncs nor allocates
    outside the graph's pool.  The Python wrapper runs (and counts) once,
    at capture."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    x = torch.randn(8, 4096, generator=gen, device=cuda_device).bfloat16()
    g = (1 + torch.randn(4096, generator=gen, device=cuda_device)).bfloat16()
    fresh = torch.randn(8, 4096, generator=gen, device=cuda_device).bfloat16()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):                      # warm-up
        rn.rmsnorm(x, g, layer_form=True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = rn.LAUNCHES["rmsnorm"]
    with torch.cuda.graph(graph):
        out = rn.rmsnorm(x, g, layer_form=True)
    assert rn.LAUNCHES["rmsnorm"] == before + 1
    x.copy_(fresh)
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert rn.LAUNCHES["rmsnorm"] == before + 1
    assert torch.equal(out, rn.rmsnorm(fresh, g, layer_form=True))


@pytest.mark.parametrize("b,h,hkv,s,dh,causal,window,dtype,variant", [
    (1, 4, 4, 128, 64, False, 0, torch.float32, None),     # MHA, full
    (2, 8, 2, 256, 64, True, 0, torch.bfloat16, None),     # GQA 4:1
    (1, 4, 1, 128, 128, True, 0, torch.float32, None),     # MQA
    (1, 4, 2, 1024, 128, True, 256, torch.bfloat16, None),  # sliding window
    (1, 2, 2, 192, 16, False, 100, torch.float32, None),   # window, full
    (1, 2, 1, 128, 256, True, 0, torch.bfloat16, None),    # widest head
    (1, 32, 8, 2048, 128, True, 0, torch.bfloat16, None),  # llama3-8b heads
    (1, 32, 32, 2048, 80, True, 0, torch.bfloat16, None),  # zamba2 heads
    (1, 2, 1, 192, 80, False, 100, torch.float32, None),   # dh 80, window
    # the tensor-core kernel's edges (128-row query and kv tiles)
    (2, 8, 2, 192, 128, True, 0, torch.bfloat16, None),    # half-empty q tile
    (1, 4, 1, 320, 80, False, 0, torch.bfloat16, "tc"),    # half-full kv tile
    (1, 4, 2, 1024, 80, True, 200, torch.bfloat16, "tc"),  # dh 80, window
    (1, 4, 4, 256, 64, True, 0, torch.bfloat16, None),     # dh 64
    (1, 32, 32, 2048, 80, True, 0, torch.bfloat16, "tc"),  # zamba2 heads
])
def test_flash_kernel_matches_plain(cuda_device, b, h, hkv, s, dh, causal,
                                    window, dtype, variant):
    gen = torch.Generator(device=cuda_device).manual_seed(s + dh)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for shape in ((b, h, s, dh), (b, hkv, s, dh), (b, hkv, s, dh)))
    before = dict(fa.LAUNCHES)
    if variant is None:
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
    else:
        got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                      variant=variant)
    torch.cuda.synchronize()
    tc = fa.kernel_variant(dtype, dh, variant) == "tc"
    assert fa.LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert (fa.LAUNCHES["flash_attention_tc"]
            == before["flash_attention_tc"] + tc)
    want = fa.flash_attention(q, k, v, causal=causal, window=window,
                              impl="plain")
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_lm_kernels_reject_what_they_cannot_take(cuda_device):
    x = torch.randn(64, 32, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        rn.rmsnorm(x.t(), torch.ones(64, device=cuda_device))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        rn.rmsnorm(x.half(), torch.ones(32, device=cuda_device).half())
    q = torch.randn(1, 2, 128, 64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                           q, q)
    with pytest.raises(ValueError, match="multiples"):
        fa.flash_attention(q[:, :, :100].contiguous(),
                           q[:, :, :100].contiguous(),
                           q[:, :, :100].contiguous())
    with pytest.raises(ValueError, match="dh"):
        fa.flash_attention(q[..., :48].contiguous(), q[..., :48].contiguous(),
                           q[..., :48].contiguous())


def test_launch_failure_raises(cuda_device):
    """A launcher that refuses its arguments returns a CUDA error code;
    the wrappers' check turns it into an exception."""
    lib = load_library().lib
    x = torch.randn(4, 64, device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    code = lib.repro_rmsnorm(rn._ARGS.pack(x.data_ptr(), x.data_ptr(),
                                           x.data_ptr(), 0, 64, 1.0 / 64,
                                           1e-5, 0, 1), stream)
    assert code != 0
    with pytest.raises(RuntimeError, match="rmsnorm kernel launch failed"):
        check(code, "rmsnorm")
    code = lib.repro_flash_attention(x.data_ptr(), x.data_ptr(),
                                     x.data_ptr(), x.data_ptr(), 1, 1, 1, 64,
                                     64, 48, 0.125, 1, 0, 0, stream)
    with pytest.raises(RuntimeError, match="flash_attention kernel launch"):
        check(code, "flash_attention")
    code = lib.repro_flash_attention_tc(x.data_ptr(), x.data_ptr(),
                                        x.data_ptr(), x.data_ptr(), 1, 1, 1,
                                        64, 64, 48, 0.125, 1, 0, stream)
    assert code != 0


def test_tc_flash_raises_on_what_tma_cannot_read(cuda_device):
    """A bf16 dh-128 call launches the tensor-core kernel or raises: storage
    that TMA cannot read (not 16-byte aligned) raises, it does not fall back
    to the SIMT kernel or the plain loop."""
    q = torch.randn(1, 2, 128, 128, device=cuda_device).bfloat16()
    odd = torch.empty(q.numel() + 1, dtype=torch.bfloat16,
                      device=cuda_device)[1:].view(q.shape)
    odd.copy_(q)
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(odd, q, q)
    assert fa.LAUNCHES == before


def test_tc_flash_bwd_raises_on_what_tma_cannot_read(cuda_device):
    """The same for the backward: a bf16 dh-128 gradient launches the
    tensor-core backward or raises on storage TMA cannot read."""
    q = torch.randn(1, 2, 128, 128, device=cuda_device).bfloat16()
    odd = torch.empty(q.numel() + 1, dtype=torch.bfloat16,
                      device=cuda_device)[1:].view(q.shape)
    odd.copy_(q)
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_bwd(q, q, q, q, odd)
    assert fa.LAUNCHES == before


def test_model_forward_on_card_counts_launches(cuda_device):
    """A smoke model's forward at S=2048 on the card: 2 L + 1 rmsnorm and
    L flash launches, logits close to the plain path's."""
    cfg = get_smoke("llama3-8b")
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (1, 2048), device=cuda_device)
    before = (rn.LAUNCHES["rmsnorm"], fa.LAUNCHES["flash_attention"])
    with torch.inference_mode():
        got, _ = forward(cfg, params, {"tokens": tokens})
        torch.cuda.synchronize()
        after = (rn.LAUNCHES["rmsnorm"], fa.LAUNCHES["flash_attention"])
        want, _ = forward(cfg, params, {"tokens": tokens}, impl="plain")
    assert after == (before[0] + 2 * cfg.n_layers + 1,
                     before[1] + cfg.n_layers)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_bf16_model_forward_routes_flash_to_tensor_cores(cuda_device):
    """The llama smoke model in bf16 at dh=64 (its width otherwise): the
    forward at S=2048 runs every flash launch on the tensor-core kernel,
    with logits within 2e-2 normwise of the plain path's."""
    cfg = replace(get_smoke("llama3-8b"), dtype="bfloat16",
                  param_dtype="bfloat16", head_dim=64)
    assert fa.kernel_variant(torch.bfloat16, cfg.dh) == "tc"
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (1, 2048), device=cuda_device)
    before = dict(fa.LAUNCHES)
    with torch.inference_mode():
        got, _ = forward(cfg, params, {"tokens": tokens})
        torch.cuda.synchronize()
        after = dict(fa.LAUNCHES)
        want, _ = forward(cfg, params, {"tokens": tokens}, impl="plain")
    assert after["flash_attention"] - before["flash_attention"] == \
        after["flash_attention_tc"] - before["flash_attention_tc"] == \
        cfg.n_layers
    rel = (got.double() - want.double()).norm() / want.double().norm()
    assert float(rel) <= 2e-2


# ------------------------------------------------------------ ssm_scan
#: kernel vs plain: the same fp32 arithmetic in the same order (bf16
#: inputs are read as fp32 exactly); only exp may differ by an ulp
SSM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _scan_inputs(b, h, s, p, n, dtype, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    rnd = lambda *shape: torch.randn(shape, generator=gen,  # noqa: E731
                                     device=device)
    return (rnd(b, h, s, p).to(dtype), -rnd(b, h, s).abs() * 0.2,
            rnd(b, h, s).abs(), rnd(b, s, n).to(dtype), rnd(b, s, n).to(dtype))


@pytest.mark.parametrize("b,h,s,p,n,chunk,dtype", [
    (1, 80, 1024, 64, 64, 128, torch.bfloat16),   # zamba2 heads
    (1, 80, 1024, 64, 64, 128, torch.float32),
    (2, 3, 128, 16, 8, 64, torch.float32),        # N < 32: zero lanes
    (1, 2, 192, 32, 256, 64, torch.bfloat16),     # widest state
    (1, 1, 100, 5, 40, 100, torch.float32),       # ragged P, S, N
    # the edges of 8 threads a row, 16 rows a block, 32-step tiles
    (1, 2, 70, 16, 1, 70, torch.float32),         # N = 1: one live entry
    (1, 2, 96, 20, 33, 96, torch.bfloat16),       # N = 33, P past a block
    (1, 1, 64, 24, 255, 64, torch.float32),       # N = 255
    (2, 3, 100, 40, 64, 100, torch.bfloat16),     # B = 2, ragged tile
    (1, 2, 1, 17, 64, 1, torch.float32),          # one step
])
def test_ssm_scan_kernel_matches_plain(cuda_device, b, h, s, p, n, chunk,
                                       dtype):
    args = _scan_inputs(b, h, s, p, n, dtype, cuda_device, seed=n)
    before = ss.LAUNCHES["ssm_scan"]
    got = ss.ssm_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssm_scan"] == before + 1
    want = ss.ssm_scan(*args, chunk=chunk, impl="plain")
    assert got.dtype == torch.float32 and got.shape == (b, h, s, p)
    torch.testing.assert_close(got, want, rtol=SSM_TOL[dtype],
                               atol=SSM_TOL[dtype])


@pytest.mark.parametrize("b,h,s,p,n,dtype", [
    (1, 80, 1024, 64, 64, torch.bfloat16),        # zamba2 heads
    (1, 3, 100, 5, 40, torch.float32),            # ragged P, S, N
    (2, 3, 100, 40, 33, torch.bfloat16),
    (1, 2, 70, 16, 255, torch.float32),
])
def test_ssm_scan_kernel_is_bitwise_when_a_is_zero(cuda_device, b, h, s, p,
                                                  n, dtype):
    """With a = 0 both versions take exp(a) = 1 exactly, so the kernel
    equals the plain version bit for bit: any change of summation order
    or index shows as a nonzero difference."""
    x, a, dt, bm, cm = _scan_inputs(b, h, s, p, n, dtype, cuda_device,
                                    seed=s + n)
    a = torch.zeros_like(a)
    got = ss.ssm_scan(x, a, dt, bm, cm, chunk=s)
    want = ss.ssm_scan(x, a, dt, bm, cm, chunk=s, impl="plain")
    assert torch.equal(got, want)


def test_ssm_scan_kernel_rejects_what_it_cannot_take(cuda_device):
    x, a, dt, bm, cm = _scan_inputs(1, 2, 64, 8, 300, torch.float32,
                                    cuda_device)
    with pytest.raises(ValueError, match="state of 1 to 256"):
        ss.ssm_scan(x, a, dt, bm, cm)
    x, a, dt, bm, cm = _scan_inputs(1, 2, 64, 8, 16, torch.float32,
                                    cuda_device)
    with pytest.raises(ValueError, match="float32 a and dt"):
        ss.ssm_scan(x, a.bfloat16(), dt, bm, cm)
    with pytest.raises(ValueError, match="one type"):
        ss.ssm_scan(x.bfloat16(), a, dt, bm, cm)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssm_scan(x.transpose(2, 3).contiguous().transpose(2, 3), a, dt,
                    bm, cm)
    lib = load_library().lib
    code = lib.repro_ssm_scan(x.data_ptr(), a.data_ptr(), dt.data_ptr(),
                              bm.data_ptr(), cm.data_ptr(), x.data_ptr(), 1,
                              2, 64, 8, 300, 0,
                              torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="ssm_scan kernel launch failed"):
        check(code, "ssm_scan")


def _bwd_inputs(b, h, s, p, n, dtype, device, seed, zero_a=False):
    x, a, dt, bm, cm = _scan_inputs(b, h, s, p, n, dtype, device, seed)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    dy = torch.randn((b, h, s, p), generator=gen, device=device)
    return x, torch.zeros_like(a) if zero_a else a, dt, bm, cm, dy


@pytest.mark.parametrize("b,h,s,p,n,dtype,zero_a", [
    (1, 80, 4096, 64, 64, torch.bfloat16, False),  # zamba2's training shape
    (1, 80, 4096, 64, 64, torch.float32, False),
    (1, 4, 256, 64, 16, torch.bfloat16, False),    # N off the 32 lanes
    (1, 4, 200, 32, 40, torch.float32, False),
    (1, 2, 64, 24, 256, torch.bfloat16, False),    # the widest state
    (1, 3, 200, 20, 64, torch.float32, False),     # P off the 16-row blocks
    (2, 4, 300, 32, 64, torch.bfloat16, False),    # B = 2
    (1, 4, 8, 64, 64, torch.bfloat16, False),      # one segment
    (1, 3, 1, 17, 64, torch.float32, False),       # one step
    (1, 80, 4096, 64, 64, torch.bfloat16, True),   # a = 0: bit for bit
    (1, 3, 100, 5, 40, torch.float32, True),
    (2, 3, 100, 40, 33, torch.bfloat16, True),
])
def test_ssm_scan_bwd_kernel_matches_plain(cuda_device, b, h, s, p, n, dtype,
                                           zero_a):
    """The scan backward kernel (``variant="scan"``, forced where the table
    routes bf16 to the tensor cores) against its twin (the same sums in
    the same order): within SSM_TOL everywhere (only exp may differ), bit
    for bit at a = 0; the same from run to run (no atomics); one launch
    counted a call; dx, dB, dC in the input's type, da and ddt fp32."""
    args = _bwd_inputs(b, h, s, p, n, dtype, cuda_device, s + n + p, zero_a)
    chunk = 128 if s % 128 == 0 else s
    before = (ss.LAUNCHES["ssm_scan_bwd"], ss.LAUNCHES["ssm_scan_bwd_tc"])
    got = ss.ssm_scan_bwd(*args, chunk=chunk, variant="scan")
    again = ss.ssm_scan_bwd(*args, chunk=chunk, variant="scan")
    torch.cuda.synchronize()
    assert (ss.LAUNCHES["ssm_scan_bwd"],
            ss.LAUNCHES["ssm_scan_bwd_tc"]) == (before[0] + 2, before[1])
    want = ss.ssm_scan_bwd(*args, chunk=chunk, impl="plain")
    types = (dtype, torch.float32, torch.float32, dtype, dtype)
    for g, w, r, t in zip(got, want, again, types):
        assert g.dtype == t and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=SSM_TOL[dtype],
                                   atol=SSM_TOL[dtype])
        assert torch.equal(g, r)
        if zero_a:
            assert torch.equal(g, w)


def test_ssm_scan_bwd_kernel_rejects_and_reports_a_failed_launch(
        cuda_device):
    """What the kernel cannot take is refused before a launch; a launch
    the C entry refuses (N = 300) raises through ``check``."""
    args = _bwd_inputs(1, 2, 64, 8, 16, torch.float32, cuda_device, 0)
    with pytest.raises(ValueError, match="dy float32"):
        ss.ssm_scan_bwd(*args[:5], args[5].bfloat16())
    with pytest.raises(ValueError, match="state of 1 to 256"):
        wide = _bwd_inputs(1, 2, 64, 8, 300, torch.float32, cuda_device, 0)
        ss.ssm_scan_bwd(*wide)
    lib = load_library().lib
    assert lib.repro_ssm_scan_bwd_workspace(1, 2, 64, 8, 300) == -1
    x, a, dt, bm, cm, dy = args
    code = lib.repro_ssm_scan_bwd(
        *(t.data_ptr() for t in (x, a, dt, bm, cm, dy, x, a, dt, bm, cm,
                                 dy)),
        1, 2, 64, 8, 300, 0, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError,
                       match="ssm_scan_bwd kernel launch failed"):
        check(code, "ssm_scan_bwd")


#: The tensor-core ssm_scan backward against its bf16-operand twin,
#: besides SSM_TOL against the scan's twin: the largest 64-step tile's
#: normwise distance (each head's dx, da and ddt, each batch's dB and
#: dC), as chip_smoke.py holds it (PERF.md gives the readings it was set
#: from).
SSM_TC_TILE_NORMWISE = 1.5e-3


#: Step axis of each gradient: dx, da, ddt (B, H, S, ...); dB, dC (B, S, N).
SSM_STEP_AXES = (2, 2, 2, 1, 1)


@pytest.mark.parametrize("b,h,s,p,n", [
    (1, 80, 4096, 64, 64),    # zamba2's training shape
    (1, 8, 1000, 64, 64),     # a ragged last chunk
    (2, 4, 300, 32, 64),      # B = 2
    (1, 8, 256, 16, 16),      # the smoke config's (P, N)
    (1, 3, 200, 24, 40),
    (1, 4, 64, 64, 64),       # one whole chunk
    (2, 3, 1, 16, 64),        # one step
])
def test_ssm_scan_bwd_tc_kernel_matches_twins(cuda_device, b, h, s, p, n):
    """The tensor-core backward (the table's route for bf16 at these (P,
    N)) against its bf16-operand twin (every 64-step tile within
    :data:`SSM_TC_TILE_NORMWISE`) and against the scan's twin
    (``ssm_scan_bwd_plain``) within SSM_TOL; the same from run to run (no
    atomics); each launch counted under both keys."""
    _check_tc_against_twins(
        _bwd_inputs(b, h, s, p, n, torch.bfloat16, cuda_device, s + n))


def test_ssm_scan_bwd_tc_kernel_with_bf16_exact_dy(cuda_device):
    """As :func:`test_ssm_scan_bwd_tc_kernel_matches_twins` at zamba2's
    training shape with dy rounded to bf16, as the model's path gives it
    (y reaches the loss through y.to(bf16)): dy's lo parts are zero."""
    x, a, dt, bm, cm, dy = _bwd_inputs(1, 80, 4096, 64, 64, torch.bfloat16,
                                       cuda_device, 4096)
    _check_tc_against_twins((x, a, dt, bm, cm, dy.bfloat16().float()))


def _check_tc_against_twins(args):
    """The tensor-core backward on ``args`` (x, a, dt, Bm, Cm, dy) against
    both twins, twice, with its launches counted."""
    b, h, s, p, n = args[0].shape + args[3].shape[-1:]
    assert ss.bwd_kernel_variant(torch.bfloat16, p, n) == "tc"
    before = (ss.LAUNCHES["ssm_scan_bwd"], ss.LAUNCHES["ssm_scan_bwd_tc"])
    got = ss.ssm_scan_bwd(*args, chunk=s)
    again = ss.ssm_scan_bwd(*args, chunk=s)
    torch.cuda.synchronize()
    assert (ss.LAUNCHES["ssm_scan_bwd"], ss.LAUNCHES["ssm_scan_bwd_tc"]) \
        == (before[0] + 2, before[1] + 2)
    twin = ss.ssm_scan_bwd_chunked_plain(*args, operands="bf16")
    scan = ss.ssm_scan_bwd(*args, chunk=s, impl="plain")
    tol = SSM_TOL[torch.bfloat16]
    types = (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16,
             torch.bfloat16)
    for g, w, q, r, t, axis in zip(got, twin, scan, again, types,
                                   SSM_STEP_AXES):
        assert g.dtype == t and g.shape == q.shape
        assert torch.equal(g, r)
        assert _step_tiles(g, w, axis) <= SSM_TC_TILE_NORMWISE
        torch.testing.assert_close(g, q, rtol=tol, atol=tol)


def test_ssm_scan_bwd_tc_kernel_rejects_and_reports_a_failed_launch(
        cuda_device):
    """``variant="tc"`` is refused for fp32 and for a (P, N) the kernel
    does not take, before a launch; the C entry refuses them too (-1
    workspace, an error code that ``check`` raises)."""
    args = _bwd_inputs(1, 2, 64, 20, 16, torch.bfloat16, cuda_device, 0)
    with pytest.raises(ValueError, match="tensor-core"):
        ss.ssm_scan_bwd(*args, variant="tc")
    f32 = _bwd_inputs(1, 2, 64, 16, 16, torch.float32, cuda_device, 0)
    with pytest.raises(ValueError, match="tensor-core"):
        ss.ssm_scan_bwd(*f32, variant="tc")
    lib = load_library().lib
    assert lib.repro_ssm_scan_bwd_tc_workspace(1, 2, 64, 20, 16) == -1
    assert lib.repro_ssm_scan_bwd_tc_workspace(1, 2, 64, 16, 72) == -1
    x, a, dt, bm, cm, dy = args
    code = lib.repro_ssm_scan_bwd_tc(
        *(t.data_ptr() for t in (x, a, dt, bm, cm, dy, x, a, dt, bm, cm,
                                 dy)),
        1, 2, 64, 20, 16, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError,
                       match="ssm_scan_bwd_tc kernel launch failed"):
        check(code, "ssm_scan_bwd_tc")


def test_hybrid_forward_on_card_counts_launches(cuda_device):
    """The zamba2 smoke model's forward at S=2048 on the card: one
    ssm_scan per Mamba2 layer, one flash per super-block, 2 L + 2 n_super
    + 1 rmsnorm; logits close to the plain path's."""
    cfg = get_smoke("zamba2-2.7b")
    params = init_params(cfg, torch.Generator(device=cuda_device)
                         .manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (1, 2048), device=cuda_device)
    n_super = cfg.n_layers // cfg.attn_every
    before = (rn.LAUNCHES["rmsnorm"], ss.LAUNCHES["ssm_scan"],
              fa.LAUNCHES["flash_attention"])
    with torch.inference_mode():
        got, _ = forward(cfg, params, {"tokens": tokens})
        torch.cuda.synchronize()
        after = (rn.LAUNCHES["rmsnorm"], ss.LAUNCHES["ssm_scan"],
                 fa.LAUNCHES["flash_attention"])
        want, _ = forward(cfg, params, {"tokens": tokens}, impl="plain")
    assert after == (before[0] + 2 * cfg.n_layers + 2 * n_super + 1,
                     before[1] + cfg.n_layers, before[2] + n_super)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# ------------------------------------------------ dispatch/fetch, sweep
def _exact(got, want):
    for a, b in zip(got, want):
        for f in ("makespan", "energy_j", "peak_power_w",
                  "over_budget_time", "job_starts", "job_ends"):
            assert getattr(a, f) == getattr(b, f), f


def test_dispatch_fetch_equals_run_on_the_card(cuda_device):
    """``fetch(dispatch())`` is ``run()`` on the wave_run path, and two
    batches dispatched back to back and fetched in reverse order give
    the results each gives alone."""
    items = [(g, sp) for _, g, sp, _ in mixed_members(seed=0)]
    bounds = [sum(s.lut.p_max for s in sp) * 0.6 for _, sp in items]
    a = TorchBatchSimulator.padded(items, bounds, "heuristic")
    b = TorchBatchSimulator(is_like(8, "A"), heterogeneous_cluster(8),
                            np.linspace(20.0, 60.0, 64), "oracle")
    want_a, want_b = a.run(), b.run()
    before = ps.LAUNCHES["wave_run"]
    pa, pb = a.dispatch(), b.dispatch()
    assert ps.LAUNCHES["wave_run"] == before + 2
    got_b, got_a = b.fetch(pb), a.fetch(pa)
    _exact(got_a, want_a)
    _exact(got_b, want_b)
    for p in (pa.profile, pb.profile):
        assert p.path == "cuda" and p.kernel_ms > 0
        assert min(p.pack_s, p.dispatch_s, p.run_s, p.transfer_s,
                   p.results_s) >= 0


def test_sweep_on_the_card_matches_plain_and_plans_wide_rows_to_vector(
        cuda_device):
    """The torch executor on the card (device None) against the same
    sweep at ``impl="plain"`` on the card, bit for bit; a 300-node
    scenario plans to the vector backend with its own reason."""
    from repro_torch.core import (Scenario, SweepEngine, ep_like,
                                  mixed_family)

    cells = mixed_family(seed=0, bound_fracs=(0.4, 0.8),
                         policies=("equal-share", "oracle", "heuristic",
                                   "learned")).scenarios()
    wide = Scenario("ep300", ep_like(300, "A", seed=1),
                    tuple(homogeneous_cluster(300)), 1200.0, "equal-share")
    cells.append(wide)
    before = dict(ps.LAUNCHES)
    sweep = SweepEngine(executor="torch").run(cells)
    got = {k: ps.LAUNCHES[k] - before[k] for k in before}
    plain = SweepEngine(executor="torch", impl="plain").run(cells)
    assert not sweep.failures and not plain.failures
    assert sweep.records[-1].backend == "vector"
    assert sweep.records[-1].fallback_reason == "lanes(300>256)"
    paths = {b.path for b in sweep.profile.buckets}
    assert paths == {"cuda", "step"}            # learned: per-wave path
    n_cuda = sum(b.path == "cuda" for b in sweep.profile.buckets)
    assert got["wave_run"] == n_cuda and got["power_step"] > 0
    for a, b in zip(sweep.records, plain.records):
        assert a.backend == b.backend and a.bucket == b.bucket
        _exact([a.result], [b.result])


def test_service_on_the_card_matches_the_sweep_engine(cuda_device):
    """``SweepService(executor="torch")`` on the card (device None):
    every record, dispatched on the service's thread and fetched on its
    collector, equals ``SweepEngine(executor="torch")``'s record of the
    same cell on the card (``learned`` at rel 1e-5, vector records at
    1e-12), with the same backend and fallback reason; one wave_run
    launch a ``"cuda"`` bucket, nothing built after the kernels exist."""
    from repro_torch.core import (Scenario, SweepEngine, ep_like,
                                  mixed_family)
    from repro_torch.serving import SweepService

    cells = mixed_family(seed=0, bound_fracs=(0.4, 0.8),
                         policies=("equal-share", "oracle", "heuristic",
                                   "learned", "countdown")).scenarios()
    cells.append(Scenario("ep300", ep_like(300, "A", seed=1),
                          tuple(homogeneous_cluster(300)), 1200.0,
                          "equal-share"))
    load_library()
    offline = SweepEngine(executor="torch").run(cells)
    before = dict(ps.LAUNCHES)
    with SweepService(executor="torch", flush_deadline_s=0.05,
                      bucket_rows=16) as service:
        records = [t.result(120) for t in service.submit_many(cells)]
    got = {k: ps.LAUNCHES[k] - before[k] for k in before}
    assert not offline.failures and all(r.ok for r in records)
    for rec, off in zip(records, offline.records):
        assert (rec.backend, rec.fallback_reason) == \
            (off.backend, off.fallback_reason)
        # learned's MLP (torch) and the float64 vector backend (numpy)
        # sum lanes in an order that depends on the lane padding: the
        # service pads every bucket, the sweep runs one-graph buckets at
        # their exact N
        rel = {"learned": 1e-5}.get(rec.scenario.policy,
                                    1e-12 if rec.backend == "vector" else 0)
        if rel:
            for f in ("makespan", "energy_j", "peak_power_w"):
                assert getattr(rec.result, f) == pytest.approx(
                    getattr(off.result, f), rel=rel)
        else:
            _exact([rec.result], [off.result])
    prof = service.profile
    assert prof.compiles == 0 and prof.recompiles == 0
    n_cuda = sum(b.path == "cuda" for b in prof.buckets)
    assert got["wave_run"] == n_cuda > 0 and got["power_step"] > 0
    assert records[-1].fallback_reason == "lanes(300>256)"
    assert {b.rows for b in prof.buckets} == {16}


def test_soft_makespan_on_the_card_matches_the_cpu(cuda_device):
    """The differentiable layer's soft makespan and its gradient on the
    card against the same float64 run on the CPU (listing2, static caps
    and a two-row schedule)."""
    from repro_torch.diff.softsim import build_soft_arrays, soft_makespan

    graph, specs = listing2_graph(), homogeneous_cluster(3)
    tab = lut_table(specs)
    caps = tab.cap_floor + np.array([0.5, 0.6, 0.4]) * (tab.p_max
                                                          - tab.cap_floor)
    for value, knots in ((caps, None),
                         (np.stack([caps, caps[::-1].copy()]), [7.3])):
        out = {}
        for dev in ("cpu", cuda_device):
            soft = build_soft_arrays(graph, specs, device=dev)
            x = torch.tensor(value, dtype=torch.float64, device=dev,
                             requires_grad=True)
            val = soft_makespan(x, soft, 0.1, knot_times=knots)
            (g,) = torch.autograd.grad(val, x)
            out[str(dev)] = (float(val.detach()), g.cpu().numpy())
        (v_cpu, g_cpu), (v_gpu, g_gpu) = out["cpu"], out["cuda"]
        assert v_gpu == pytest.approx(v_cpu, rel=1e-9)
        assert np.linalg.norm(g_gpu - g_cpu) <= 1e-7 * np.linalg.norm(g_cpu)


# ------------------------------------------------------ backward kernels
@pytest.mark.parametrize("layer_form", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,offset", [
    ((8, 4096), 0), ((4096, 4096), 0), ((1001, 4096), 0), ((3, 5, 1001), 0),
    ((17, 20000), 0),
    # the configs' widths (fp32 at 8192 runs the strided kernel)
    ((4096, 1280), 0), ((4096, 2560), 0), ((4096, 8192), 0),
    # an x one element off its 16-byte alignment: the strided kernel
    ((37, 4096), 1)])
def test_rmsnorm_bwd_kernel_matches_plain(cuda_device, shape, offset, dtype,
                                          layer_form):
    """The backward kernel against its plain twin (the same sums in the
    same order): bit for bit on the vector path, within TOL on the
    strided kernel's rows; one launch counted; the same from run to
    run."""
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    n = int(np.prod(shape))
    x = (3 * torch.randn(n + offset, generator=gen, device=cuda_device)
         ).to(dtype)[offset:].view(shape)
    g = (1 + torch.randn(shape[-1], generator=gen,
                         device=cuda_device)).to(dtype)
    dy = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    widest = 8192 if dtype == torch.bfloat16 else 4096
    assert rn.bwd_vector_path(x, g, dy) == (
        offset == 0 and shape[-1] % 8 == 0 and shape[-1] <= widest)
    before = rn.LAUNCHES["rmsnorm_bwd"]
    dx, dg = rn.rmsnorm_bwd(x, g, dy, layer_form=layer_form)
    again = rn.rmsnorm_bwd(x, g, dy, layer_form=layer_form)
    torch.cuda.synchronize()
    assert rn.LAUNCHES["rmsnorm_bwd"] == before + 2
    want = rn.rmsnorm_bwd(x, g, dy, layer_form=layer_form, impl="plain")
    for got, ref, rerun in zip((dx, dg), want, again):
        assert got.dtype == dtype and got.shape == ref.shape
        torch.testing.assert_close(got, ref, rtol=TOL[dtype],
                                   atol=TOL[dtype])
        assert torch.equal(got, rerun)
        if rn.bwd_vector_path(x, g, dy):
            assert torch.equal(got, ref)


@pytest.mark.parametrize("b,h,hkv,s,dh,causal,window,dtype,variant", [
    (1, 4, 1, 128, 16, True, 0, torch.float32, None),
    (1, 8, 2, 192, 32, False, 0, torch.bfloat16, None),
    (2, 4, 4, 256, 64, True, 100, torch.bfloat16, None),
    (1, 4, 2, 256, 80, False, 0, torch.float32, None),
    (1, 4, 1, 320, 128, True, 0, torch.bfloat16, None),
    (1, 2, 1, 128, 256, True, 70, torch.float32, None),
    (1, 2, 2, 128, 256, False, 0, torch.bfloat16, None),
    # the tensor-core kernel: GQA groups 1, 4 and 8, every mask, a 64-row
    # last tile (S = 64 mod 128), dh 64 and 128 by the table
    (1, 2, 2, 192, 64, False, 0, torch.bfloat16, None),
    (1, 8, 2, 512, 128, True, 0, torch.bfloat16, None),
    (2, 8, 1, 320, 64, True, 96, torch.bfloat16, None),
    (1, 4, 1, 448, 128, False, 130, torch.bfloat16, None),
    (1, 4, 4, 1024, 128, True, 256, torch.bfloat16, None),
    # the SIMT kernel forced at a shape the table sends to the tensor cores
    (1, 4, 1, 320, 128, True, 0, torch.bfloat16, "simt"),
    # the tensor-core kernel at dh 80 (zamba2's and hubert's head dim):
    # zamba2's layout (H = Hkv, causal), hubert's (H = Hkv = 16, full), a
    # window, a GQA group of 4, 64-row last tiles; the SIMT kernel forced
    (1, 8, 8, 1024, 80, True, 0, torch.bfloat16, None),
    (1, 16, 16, 512, 80, False, 0, torch.bfloat16, None),
    (1, 4, 2, 1024, 80, True, 200, torch.bfloat16, None),
    (1, 8, 2, 512, 80, True, 0, torch.bfloat16, None),
    (2, 4, 1, 320, 80, True, 96, torch.bfloat16, None),
    (1, 4, 1, 448, 80, False, 130, torch.bfloat16, None),
    (1, 4, 4, 320, 80, True, 0, torch.bfloat16, "simt"),
])
def test_flash_bwd_kernel_matches_plain(cuda_device, b, h, hkv, s, dh,
                                        causal, window, dtype, variant):
    """The backward kernel (the table's, or the one a case forces) against
    its plain twin on the forward kernel's output: the tensor-core kernel
    against the bf16-operand twin, elementwise and to
    :data:`TC_BWD_TILE_NORMWISE` over each 64-row tile of each head, the
    SIMT one against the fp32 twin; every head dim, GQA, masks; the same
    from run to run (no atomics); each launch counted, the tensor-core
    kernel's also on its own."""
    gen = torch.Generator(device=cuda_device).manual_seed(s + dh)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               for shape in ((b, h, s, dh), (b, hkv, s, dh),
                             (b, hkv, s, dh)))
    do = torch.randn((b, h, s, dh), generator=gen,
                     device=cuda_device).to(dtype)
    o = fa.flash_attention(q, k, v, causal=causal, window=window)
    ran = fa.bwd_kernel_variant(dtype, dh, variant)
    before = dict(fa.LAUNCHES)
    got = fa.flash_attention_bwd_cuda(q, k, v, o, do, causal, window,
                                      variant)
    again = fa.flash_attention_bwd_cuda(q, k, v, o, do, causal, window,
                                        variant)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention_bwd"] == \
        before["flash_attention_bwd"] + 2
    assert fa.LAUNCHES["flash_attention_bwd_tc"] == \
        before["flash_attention_bwd_tc"] + (2 if ran == "tc" else 0)
    want = fa.flash_attention_bwd_plain(
        q, k, v, o, do, causal, window,
        operands="bf16" if ran == "tc" else "fp32")
    for g, w, r in zip(got, want, again):
        assert g.dtype == dtype and g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=TOL[dtype], atol=TOL[dtype])
        assert torch.equal(g, r)
        if ran == "tc":
            assert _step_tiles(g, w, 2) <= TC_BWD_TILE_NORMWISE


#: One smoke config a family, at S=2048 (the flash path) with remat: (arch,
#: dtype, head_dim override).  The MoE and xLSTM models run in fp32: with
#: bf16 random weights, a rounding flips near-tied expert choices and the
#: whole-model gradients then differ past the bar for that alone (the
#: serve and prefill phases meet the same with the routing handed over);
#: in fp32 the kernels equal the plain path bit for bit.  hubert (bf16 dh
#: 80, non-causal), llama and chameleon (bf16 dh 64) take the tensor-core
#: flash backward (hubert's forward the SIMT kernel), zamba2 the SIMT one
#: at its smoke dh 16 and ssm_scan's tensor-core backward (bf16, P = N =
#: 16).
TRAIN_FAMILIES = {"dense": ("llama3-8b", "bfloat16", 64),
                  "moe": ("moonshot-v1-16b-a3b", "float32", None),
                  "hybrid": ("zamba2-2.7b", "bfloat16", None),
                  "ssm": ("xlstm-350m", "float32", None),
                  "vlm": ("chameleon-34b", "bfloat16", 64),
                  "encoder": ("hubert-xlarge", "bfloat16", 80)}


def _train_launches(cfg):
    """One training step's launches with remat (see ``models/model.py``):
    every remat'd block's kernels run in the forward and again in its
    recompute; the hybrid's Mamba2 layers and the xLSTM's mLSTM layers
    sit under a checkpoint inside their super-block's, so they run three
    times; one backward kernel a forward call."""
    from repro_torch.models.model import superblock_shape

    L = cfg.n_layers
    n = superblock_shape(cfg)[0]
    want = dict.fromkeys(("rmsnorm", "rmsnorm_bwd", "flash_attention",
                          "flash_attention_tc", "flash_attention_bwd",
                          "flash_attention_bwd_tc", "ssm_scan",
                          "ssm_scan_bwd", "ssm_scan_bwd_tc"), 0)
    if cfg.family == "hybrid":
        want.update(rmsnorm=6 * L + 4 * n + 1, rmsnorm_bwd=2 * L + 2 * n + 1,
                    flash_attention=2 * n, flash_attention_bwd=n,
                    ssm_scan=3 * L, ssm_scan_bwd=L)
    elif cfg.family == "ssm":
        want.update(rmsnorm=6 * (L - n) + 4 * n + 1, rmsnorm_bwd=2 * L + 1)
    else:
        want.update(rmsnorm=4 * L + 1, rmsnorm_bwd=2 * L + 1,
                    flash_attention=2 * L, flash_attention_bwd=L)
    dtype = getattr(torch, cfg.dtype)
    if fa.kernel_variant(dtype, cfg.dh) == "tc":
        want["flash_attention_tc"] = want["flash_attention"]
    if fa.bwd_kernel_variant(dtype, cfg.dh) == "tc":
        want["flash_attention_bwd_tc"] = want["flash_attention_bwd"]
    if cfg.family == "hybrid" and ss.bwd_kernel_variant(
            dtype, cfg.ssm.head_dim, cfg.ssm.state_dim) == "tc":
        want["ssm_scan_bwd_tc"] = want["ssm_scan_bwd"]
    return want


@pytest.mark.parametrize("family", list(TRAIN_FAMILIES))
def test_train_grads_on_card_match_plain(cuda_device, family):
    """One loss and backward of each family's smoke model at S=2048 with
    remat on: every kernel launched as the model module's training
    formula says (forward, recompute, backward), and the loss and every
    gradient within 2e-2 normwise of the plain path's."""
    _train_grads_match_plain(cuda_device, family, *TRAIN_FAMILIES[family])


def test_hybrid_at_dh80_trains_through_the_tc_backward(cuda_device):
    """The hybrid smoke model with its shared attention block at zamba2's
    head dim (bf16 dh 80): the flash forward on the SIMT kernel, its
    backward on the tensor-core kernel (the launch formula's counts), the
    loss and every gradient within 2e-2 normwise of the plain path's."""
    from repro_torch.models.model import superblock_shape

    cfg = _train_grads_match_plain(cuda_device, "hybrid", "zamba2-2.7b",
                                   "bfloat16", 80)
    assert fa.kernel_variant(torch.bfloat16, cfg.dh) == "simt"
    assert _train_launches(cfg)["flash_attention_bwd_tc"] == \
        superblock_shape(cfg)[0] > 0


def _train_grads_match_plain(cuda_device, family, arch, dtype, head_dim):
    from repro_torch.models import loss_fn

    cfg = replace(get_smoke(arch), dtype=dtype, param_dtype=dtype,
                  remat=True, **({"head_dim": head_dim} if head_dim else {}))
    assert cfg.family == family
    model = init_params(cfg, torch.Generator(device=cuda_device)
                        .manual_seed(0)).requires_grad_(True)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    batch = {"labels": torch.randint(0, cfg.vocab, (1, 2048), generator=gen,
                                     device=cuda_device)}
    if family == "encoder":
        batch["frames"] = torch.randn((1, 2048, cfg.d_model), generator=gen,
                                      device=cuda_device)
    else:
        batch["tokens"] = torch.randint(0, cfg.vocab, (1, 2048),
                                        generator=gen, device=cuda_device)
    runs = {}
    for impl in (None, "plain"):
        before = {**rn.LAUNCHES, **fa.LAUNCHES, **ss.LAUNCHES}
        loss, _ = loss_fn(cfg, model, batch, impl=impl)
        loss.backward()
        torch.cuda.synchronize()
        after = {**rn.LAUNCHES, **fa.LAUNCHES, **ss.LAUNCHES}
        runs[impl] = (float(loss.detach()), {n: p.grad.clone()
                                    for n, p in model.named_parameters()},
                      {k: after[k] - before[k] for k in after})
        model.zero_grad(set_to_none=True)
    assert runs[None][2] == _train_launches(cfg)
    assert not any(runs["plain"][2].values())
    assert runs[None][0] == pytest.approx(runs["plain"][0], rel=2e-2)
    for name, g in runs[None][1].items():
        w = runs["plain"][1][name].double()
        assert float((g.double() - w).norm()) <= 2e-2 * float(w.norm()), name
    return cfg


def test_ssm_scan_grads_on_card_match_twin(cuda_device):
    """Under grad on the card, ``ssm_scan`` runs the forward kernel and
    its backward kernel (one launch each, through ``SsmScanFunction``) and
    the gradients equal the plain route's (the twin's) within SSM_TOL;
    inputs that need no gradient get none."""
    x, a, dt, bm, cm, dy = _bwd_inputs(1, 3, 256, 40, 64, torch.bfloat16,
                                       cuda_device, 3)
    runs = {}
    for impl in (None, "plain"):
        leaves = [t.clone().requires_grad_(i != 1)
                  for i, t in enumerate((x, a, dt, bm, cm))]
        before = (ss.LAUNCHES["ssm_scan"], ss.LAUNCHES["ssm_scan_bwd"])
        y = ss.ssm_scan(*leaves, chunk=128, impl=impl)
        y.backward(dy)
        torch.cuda.synchronize()
        ran = (ss.LAUNCHES["ssm_scan"] - before[0],
               ss.LAUNCHES["ssm_scan_bwd"] - before[1])
        assert ran == ((1, 1) if impl is None else (0, 0))
        assert leaves[1].grad is None
        runs[impl] = (y.detach(), [t.grad for t in leaves])
    torch.testing.assert_close(runs[None][0], runs["plain"][0],
                               rtol=SSM_TOL[torch.bfloat16],
                               atol=SSM_TOL[torch.bfloat16])
    for g, w in zip(runs[None][1], runs["plain"][1]):
        if w is None:
            continue
        assert g.dtype == w.dtype
        torch.testing.assert_close(g, w, rtol=SSM_TOL[torch.bfloat16],
                                   atol=SSM_TOL[torch.bfloat16])
