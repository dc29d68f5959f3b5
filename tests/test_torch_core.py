"""The port's own copies of the reference's numpy modules match it.

Same seed, same graphs and LUTs; the geometry builders give equal
arrays; the ILP gives the same assignments; ``convert.from_reference``
carries objects across faithfully.  Also: no module of ``repro_torch``,
and not ``chip_smoke.py``, ``flash_probe.py``, ``ssm_probe.py``,
``ssm_bwd_probe.py``, ``rmsnorm_probe.py`` or ``profiler_probe.py``,
imports ``jax`` or
anything of ``repro``; ``chip_smoke.py`` fails without a GPU and outside
the repository, the probes without a GPU.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import batchsim as ref_bs
from repro.core import ilp as ref_ilp
from repro.core import power as ref_power
from repro.core import workloads as ref_wl
from repro.core.scenarios import mixed_family

from repro_torch.convert import from_reference
from repro_torch.core import arrays as port_arrays
from repro_torch.core import ilp as port_ilp
from repro_torch.core import power as port_power
from repro_torch.core import workloads as port_wl

ROOT = Path(__file__).resolve().parents[1]


def graph_key(g):
    return sorted((j.node, j.index, j.work, j.cpu_frac, tuple(j.deps), j.tag)
                  for j in g.jobs.values())


def spec_key(s):
    lut = s.lut
    states = lambda ss: tuple((x.freq_mhz, x.power_w) for x in ss)  # noqa
    return (lut.name, states(lut.states), lut.idle_w, lut.cores,
            tuple(sorted((m, states(v)) for m, v in lut.multicore.items())),
            s.speed)


GENERATORS = [
    ("listing2_graph", (), {}),
    ("listing2_uniform", (7.0,), {}),
    ("listing2_random", (3.0,), {"seed": 11}),
    ("is_like", (5, "B"), {"seed": 3}),
    ("is_like", (64, "C"), {}),
    ("ep_like", (4, "A"), {"seed": 9}),
    ("cg_like", (4, "A"), {"seed": 8}),
    ("pipeline_graph", (3, 4), {"skew": 0.2, "seed": 5}),
    ("layered_dag", (5,), {"seed": 12}),
    ("fork_join_graph", (4,), {"seed": 13}),
    ("moe_step_graph", (6,), {"layers": 3, "seed": 14}),
]


@pytest.mark.parametrize("name,args,kw", GENERATORS,
                         ids=[f"{g[0]}-{i}" for i, g in enumerate(GENERATORS)])
def test_workload_generators_same_graph_for_same_seed(name, args, kw):
    ref = getattr(ref_wl, name)(*args, **kw)
    port = getattr(port_wl, name)(*args, **kw)
    assert graph_key(port) == graph_key(ref)
    assert port.to_text() == ref.to_text()
    assert port.max_depths() == ref.max_depths()


@pytest.mark.parametrize("n,seed", [(1, 0), (4, 0), (7, 3), (64, 0)])
def test_clusters_and_luts_match(n, seed):
    ref = ref_power.heterogeneous_cluster(n, seed=seed)
    port = port_power.heterogeneous_cluster(n, seed=seed)
    assert [spec_key(s) for s in port] == [spec_key(s) for s in ref]
    assert [spec_key(s) for s in port_power.homogeneous_cluster(n)] == \
        [spec_key(s) for s in ref_power.homogeneous_cluster(n)]
    lut = port_power.tpu_v5e_lut()
    assert spec_key(port_power.NodeSpec(lut)) == \
        spec_key(ref_power.NodeSpec(ref_power.tpu_v5e_lut()))
    assert port_power.min_feasible_cluster_bound(port) == \
        ref_power.min_feasible_cluster_bound(ref)
    assert port_power.max_useful_cluster_bound(port) == \
        ref_power.max_useful_cluster_bound(ref)
    for name in ("state_p", "state_f", "idle_w", "p_min", "p_max", "f_min",
                 "f_nom", "span", "speed", "cap_floor"):
        np.testing.assert_array_equal(
            getattr(port_power.lut_table(port), name),
            getattr(ref_power.lut_table(ref), name))


def test_mixed_members_match_mixed_family():
    fam = mixed_family(seed=3)
    port = port_wl.mixed_members(seed=3)
    assert [m.name for m in fam.members] == [p[0] for p in port]
    for m, (_name, graph, specs, steps) in zip(fam.members, port):
        assert graph_key(graph) == graph_key(m.graph)
        assert [spec_key(s) for s in specs] == [spec_key(s) for s in m.specs]
        assert steps == m.bound_steps


def test_geometry_builders_match():
    """build_graph_arrays / stack_graph_arrays / pad_bound_schedules give
    equal arrays, phantom padding included."""
    fam = mixed_family(seed=1)
    ref_items = [(m.graph, m.specs) for m in fam.members]
    port_items = [(g, s) for _n, g, s, _st in port_wl.mixed_members(seed=1)]
    for (rg, rs), (pg, pspecs) in zip(ref_items, port_items):
        ra = ref_bs.build_graph_arrays(rg, rs)
        pa = port_arrays.build_graph_arrays(pg, pspecs)
        assert pa.job_ids == ra.job_ids
        for name in ("work_pad", "rho_pad", "node_seq", "deps_pad"):
            np.testing.assert_array_equal(getattr(pa, name),
                                          getattr(ra, name))
    for pad in (None, (8, 80, 24, 8, 12)):
        ra = ref_bs.stack_graph_arrays(ref_items, pad)
        pa = port_arrays.stack_graph_arrays(port_items, pad)
        assert pa.row_job_ids == ra.row_job_ids
        for name in ("n_jobs_row", "n_active", "work_pad", "rho_pad",
                     "node_seq", "deps_pad"):
            np.testing.assert_array_equal(getattr(pa, name),
                                          getattr(ra, name))
        for name in ("state_p", "state_f", "idle_w", "p_min", "p_max",
                     "f_min", "f_nom", "span", "speed", "cap_floor"):
            np.testing.assert_array_equal(getattr(pa.table, name),
                                          getattr(ra.table, name))
    scheds = [(), ((8.0, 3.0), (2.0, 5.0), (8.0, 1.0)), ((0.0, 9.0),)]
    for got, want in zip(port_arrays.pad_bound_schedules(scheds, 3),
                         ref_bs.pad_bound_schedules(scheds, 3)):
        np.testing.assert_array_equal(got, want)
    assert port_arrays.pad_bound_schedules([(), ()], 2) is None
    with pytest.raises(ValueError, match=">= 0"):
        port_arrays.pad_bound_schedules([((-1.0, 2.0),)], 1)
    with pytest.raises(ValueError, match="pad_dims"):
        port_arrays.stack_graph_arrays(port_items, (2, 2, 2, 1, 1))


@pytest.mark.parametrize("bound", [2.5, 6.0, 12.0])
def test_paper_ilp_matches(bound):
    g, specs = ref_wl.listing2_graph(), ref_power.homogeneous_cluster(3)
    ref = ref_ilp.solve_paper_ilp(g, specs, bound)
    port = port_ilp.solve_paper_ilp(from_reference(g),
                                    from_reference(specs), bound)
    assert port.bounds_w.keys() == ref.bounds_w.keys()
    for jid, w in ref.bounds_w.items():
        assert abs(port.bounds_w[jid] - w) <= 1e-9
    assert abs(port.objective_t - ref.objective_t) <= 1e-9


def test_makespan_milp_and_equal_share_match():
    g, specs = ref_wl.listing2_graph(), ref_power.homogeneous_cluster(3)
    pg, ps = from_reference(g), from_reference(specs)
    ref = ref_ilp.build_makespan_milp(g, specs, 6.0)
    port = port_ilp.build_makespan_milp(pg, ps, 6.0)
    for jid, w in ref.bounds_w.items():
        assert abs(port.bounds_w[jid] - w) <= 1e-9
    eq_ref = ref_ilp.equal_share_assignment(g, specs, 6.0)
    eq_port = port_ilp.equal_share_assignment(pg, ps, 6.0)
    assert eq_port.times == eq_ref.times
    assert port_ilp.assignment_peak_power(pg, eq_port, ps) == \
        ref_ilp.assignment_peak_power(g, eq_ref, specs)


def test_convert_round_trips():
    """Graphs, clusters, tables, geometry and assignments cross over
    field for field; unknown objects raise."""
    g = ref_wl.is_like(4, "A", seed=2)
    specs = ref_power.heterogeneous_cluster(4, seed=1)
    assert graph_key(from_reference(g)) == graph_key(g)
    assert [spec_key(s) for s in from_reference(specs)] == \
        [spec_key(s) for s in specs]
    ga = ref_bs.build_graph_arrays(g, specs)
    pa = from_reference(ga)
    assert pa.job_ids == ga.job_ids
    np.testing.assert_array_equal(pa.table.cap_floor, ga.table.cap_floor)
    a = ref_ilp.equal_share_assignment(g, specs, 20.0)
    assert from_reference(a).bounds_w == a.bounds_w
    state = from_reference({"x": np.ones((2, 3)), "i": np.arange(4)})
    assert state["x"].dtype.is_floating_point and state["x"].shape == (2, 3)
    assert str(state["i"].dtype) == "torch.int64"
    with pytest.raises(TypeError, match="no port counterpart"):
        from_reference(object())


_IMPORT_CHECK = """
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
named = {{"repro_torch.configs.llama3_8b", "repro_torch.kernels.rmsnorm",
         "repro_torch.kernels.flash_attention", "repro_torch.kernels.ops",
         "repro_torch.kernels.ref", "repro_torch.models.layers",
         "repro_torch.models.attention", "repro_torch.models.model",
         "repro_torch.models.moe", "repro_torch.models.xlstm",
         "repro_torch.serving.engine", "repro_torch.launch.steps",
         "repro_torch.launch.serve", "repro_torch.core.block_detector",
         "repro_torch.core.heuristic", "repro_torch.core.simulator",
         "repro_torch.core.batchsim", "repro_torch.core.sweep",
         "repro_torch.core.scenarios", "repro_torch.policies.base",
         "repro_torch.policies.equal_share",
         "repro_torch.policies.ilp_static",
         "repro_torch.policies.online_heuristic",
         "repro_torch.policies.oracle", "repro_torch.policies.countdown",
         "repro_torch.policies.vector", "repro_torch.policies.learned",
         "repro_torch.obs.trace", "repro_torch.backends.profile",
         "repro_torch.obs.metrics", "repro_torch.serving.service",
         "repro_torch.serving.stream", "repro_torch.obs.timeline",
         "repro_torch.traces", "repro_torch.traces.schema",
         "repro_torch.traces.calibrate", "repro_torch.traces.reconstruct",
         "repro_torch.traces.replay", "repro_torch.traces.record",
         "repro_torch.traces.corpus", "repro_torch.traces.cli",
         "repro_torch.traces.__main__", "repro_torch.cluster",
         "repro_torch.cluster.arrivals", "repro_torch.cluster.policies",
         "repro_torch.cluster.scheduler", "repro_torch.cluster.metrics",
         "repro_torch.cluster.cli", "repro_torch.cluster.__main__",
         "repro_torch.diff", "repro_torch.diff.relax",
         "repro_torch.diff.softsim", "repro_torch.diff.optimize",
         "repro_torch.diff.train", "repro_torch.diff.__main__"}}
assert named <= set(names), sorted(named - set(names))
import chip_smoke
import flash_probe
import ssm_probe
import ssm_bwd_probe
import rmsnorm_probe
import profiler_probe
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
assert not bad, bad
"""


def test_port_imports_neither_jax_nor_reference():
    """Walk the package in a fresh interpreter: importing every module
    (the LM path's, the sweep front end's and the differentiable
    layer's among them),
    ``chip_smoke.py``, ``flash_probe.py``, ``ssm_probe.py``,
    ``ssm_bwd_probe.py``, ``rmsnorm_probe.py`` and ``profiler_probe.py``
    loads no ``jax`` and no ``repro``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_CHECK.format(root=str(ROOT))],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[0] != "0"


def _run_smoke(cwd, script):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, env=env, cwd=cwd, timeout=120)


def test_chip_smoke_fails_without_gpu(tmp_path):
    """No CUDA device: a nonzero exit and no result line, in the
    repository and in a directory holding only the script."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", script)
        proc = _run_smoke(cwd, script)
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_flash_probe_fails_without_gpu():
    """No CUDA device: a nonzero exit and no measurement line."""
    proc = _run_smoke(ROOT, ROOT / "flash_probe.py")
    assert proc.returncode != 0
    assert '"probe"' not in proc.stdout


def test_ssm_bwd_probe_fails_without_gpu():
    """No CUDA device: a nonzero exit and no measurement line."""
    proc = _run_smoke(ROOT, ROOT / "ssm_bwd_probe.py")
    assert proc.returncode != 0
    assert '"probe"' not in proc.stdout


def test_profiler_probe_fails_without_gpu(tmp_path):
    """No CUDA device: a nonzero exit, no measurement line, no file."""
    out = tmp_path / "probe.jsonl"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, str(ROOT / "profiler_probe.py"), "--out", str(out)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert proc.returncode != 0
    assert '"probe"' not in proc.stdout
    assert not out.exists()


def test_profiler_sessions_hold_and_count(monkeypatch):
    """``chip_smoke.profiler_session`` keeps the host idle at both ends of
    a session (its first launch then lies well inside it), and
    ``device_ms``'s floor of records a session must hold is the port's
    launches times ``KERNELS_PER_LAUNCH`` (the tensor-core counters are
    sub-counts, not added twice)."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rn

    assert chip_smoke.PROFILE_HOLD_S >= 0.02
    assert "flash_attention_tc" not in chip_smoke.KERNELS_PER_LAUNCH
    assert "flash_attention_bwd_tc" not in chip_smoke.KERNELS_PER_LAUNCH
    before = chip_smoke._kernels_launched()
    monkeypatch.setitem(fa.LAUNCHES, "flash_attention_bwd",
                        fa.LAUNCHES["flash_attention_bwd"] + 2)
    monkeypatch.setitem(fa.LAUNCHES, "flash_attention_bwd_tc",
                        fa.LAUNCHES["flash_attention_bwd_tc"] + 2)
    monkeypatch.setitem(rn.LAUNCHES, "rmsnorm_bwd",
                        rn.LAUNCHES["rmsnorm_bwd"] + 1)
    assert chip_smoke._kernels_launched() - before == 2 * 3 + 2


def test_ssm_tc_backward_counts_three_kernels(monkeypatch):
    """A tensor-core ssm_scan backward (counted under ``ssm_scan_bwd`` and
    ``ssm_scan_bwd_tc``) is three device kernels in ``device_ms``'s floor,
    a scan one (``ssm_scan_bwd`` alone) two."""
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke
    from repro_torch.kernels import ssm_scan as ss

    before = chip_smoke._kernels_launched()
    for key, n in (("ssm_scan_bwd", 3), ("ssm_scan_bwd_tc", 1)):
        monkeypatch.setitem(ss.LAUNCHES, key, ss.LAUNCHES[key] + n)
    assert chip_smoke._kernels_launched() - before == 3 + 2 * 2


@pytest.mark.parametrize("form,lo_chunks", [
    (None, 6), ("mixed", 4), ("bf16", 0)])
def test_ssm_tc_bound_counts_the_products_dy_needs(monkeypatch, form,
                                                   lo_chunks):
    """The tensor-core ssm_scan backward's bound counts 17 products of
    64^3 a head and chunk, 4 more for a chunk whose dy has a lo part, and
    one B C^T a chunk: here 2 heads, 3 chunks (the last ragged)."""
    import torch

    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    shape = (1, 2, 130, 64, 64)
    dy = torch.randn(1, 2, 130, 64, generator=torch.Generator().manual_seed(3))
    if form is not None:    # dy without a lo part: everywhere, or chunk 0
        rounded = dy.bfloat16().float()
        if form == "mixed":
            rounded[:, :, 64:] = dy[:, :, 64:]
        dy = rounded
    nbytes, ops = chip_smoke._ssm_tc_bwd_bytes_ops(torch, shape, 2, dy)
    assert nbytes == chip_smoke._ssm_bwd_bytes_ops(shape, 2)[0]
    assert ops == (17 * 6 + 4 * lo_chunks + 3) * 2 * 64 ** 3


_SSM_PROBE_VARIANTS = ("butterfly", "steps16", "steps64", "warps2", "warps8",
                       "load1", "load4", "slots2", "unroll2", "no_fill",
                       "no_reduce", "bc_once")


@pytest.mark.parametrize("variant", _SSM_PROBE_VARIANTS)
def test_ssm_probe_variant_edits_match_the_kernel(monkeypatch, variant):
    """Each of ``ssm_probe.py``'s variants edits ``csrc/ssm_scan.cu``'s
    text: every edit matches the source exactly once and changes it, so
    an edit of the kernel that breaks a variant fails here, not on the
    card."""
    monkeypatch.syspath_prepend(str(ROOT))
    import ssm_probe

    edits = {**ssm_probe.VARIANTS, **ssm_probe.ABLATIONS}
    assert sorted(edits) == sorted(["shipped", *_SSM_PROBE_VARIANTS])
    text = ssm_probe.SOURCE.read_text()
    assert ssm_probe.variant_source(text, edits["shipped"]) == text
    assert ssm_probe.variant_source(text, edits[variant]) != text


_RMSNORM_PROBE_VARIANTS = ("threads128", "threads512", "pdl")


@pytest.mark.parametrize("variant", _RMSNORM_PROBE_VARIANTS)
def test_rmsnorm_probe_variant_edits_match_the_kernel(monkeypatch, variant):
    """Each of ``rmsnorm_probe.py``'s variants edits ``csrc/rmsnorm.cu``'s
    text: every edit matches the source exactly once and changes it, and
    the block size it declares is the one its edit sets."""
    monkeypatch.syspath_prepend(str(ROOT))
    import rmsnorm_probe

    assert sorted(rmsnorm_probe.VARIANTS) == sorted(
        ["shipped", *_RMSNORM_PROBE_VARIANTS])
    text = rmsnorm_probe.SOURCE.read_text()
    threads, edits = rmsnorm_probe.VARIANTS[variant]
    assert rmsnorm_probe.variant_source(text, []) == text
    edited = rmsnorm_probe.variant_source(text, edits)
    assert edited != text
    assert f"constexpr int kThreads = {threads};" in edited


@pytest.mark.parametrize("variant", ("rows8", "rows32", "no_prefetch"))
def test_rmsnorm_probe_bwd_variant_edits_match_the_kernel(monkeypatch,
                                                          variant):
    """Each of ``rmsnorm_probe.py``'s backward variants edits
    ``csrc/rmsnorm_bwd.cu``'s text: every edit matches the source exactly
    once and changes it, and the rows a block it declares are the ones its
    edit sets."""
    monkeypatch.syspath_prepend(str(ROOT))
    import rmsnorm_probe

    assert sorted(rmsnorm_probe.BWD_VARIANTS) == sorted(
        ["tree", "rows8", "rows32", "no_prefetch"])
    text = rmsnorm_probe.BWD_SOURCE.read_text()
    rows, edits = rmsnorm_probe.BWD_VARIANTS[variant]
    edited = rmsnorm_probe.variant_source(text, edits)
    assert edited != text
    assert f"constexpr int kRows = {rows};" in edited


def test_rmsnorm_probe_fails_without_gpu():
    """No CUDA device: a nonzero exit and no measurement line."""
    proc = _run_smoke(ROOT, ROOT / "rmsnorm_probe.py")
    assert proc.returncode != 0
    assert '"probe"' not in proc.stdout
    assert "no CUDA device" in proc.stderr


def test_ssm_probe_fails_without_gpu():
    """No CUDA device: a nonzero exit, no measurement line, nothing
    built."""
    proc = _run_smoke(ROOT, ROOT / "ssm_probe.py")
    assert proc.returncode != 0
    assert '"probe"' not in proc.stdout
    assert "no CUDA device" in proc.stderr
