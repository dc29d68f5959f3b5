"""The port's HLO parser, job-graph extraction and roofline
(``repro_torch.core.hlo``, ``hlo_extract``, ``roofline``), held against
the reference's: the nine cases of ``tests/test_hlo_roofline.py`` run on
both packages, the roofline rows under the reference's v5e constants at
rtol 1e-12, and ``step_job_graph`` giving one graph from HLO text and
from its ``(kind, bytes)`` schedule."""

import dataclasses
import importlib
import json

import numpy as np
import pytest

from repro_torch.configs import ARCH_IDS, cell_status, get_config
from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, PREFILL_32K,
                                      TRAIN_4K)
from repro_torch.core import hlo_extract, roofline
from repro_torch.core.hlo import collective_schedule

HLO = """
HloModule jit_step

%inner_body (p: (s32[], bf16[128,256])) -> (s32[], bf16[128,256]) {
  %ag = bf16[128,256]{1,0} all-gather(%x), replica_groups=[16,16]<=[256]
  ROOT %t = (s32[], bf16[128,256]) tuple(%i, %ag)
}

%inner_cond (p: (s32[], bf16[128,256])) -> pred[] {
  ROOT %cmp = pred[] compare(%i, %n), direction=LT
}

ENTRY %main (a: bf16[128,256]) -> bf16[128,256] {
  %ar = bf16[128,256]{1,0} all-reduce(%a), to_apply=%sum
  %w = (s32[], bf16[128,256]) while(%init), condition=%inner_cond, body=%inner_body, backend_config={"known_trip_count":{"n":"32"}}
  ROOT %out = bf16[128,256]{1,0} get-tuple-element(%w), index=1
}
"""

PACKAGES = ["repro", "repro_torch"]

ARTIFACT = {
    "arch": "llama3-8b", "shape": "train_4k", "mesh": "pod16x16",
    "n_devices": 256, "peak_bytes_per_device": 8 * 2**30,
    "cost": {"flops": 1e12},
    "collectives_per_device_loop_corrected": {
        "all-reduce": 10 * 2**20, "all-gather": 5 * 2**20},
    "n_microbatches": 2,
}


def mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def graph_key(g):
    return sorted((j.node, j.index, j.work, j.cpu_frac, tuple(j.deps), j.tag)
                  for j in g.jobs.values())


def row(pkg, record, **kw):
    """The package's roofline row under the reference's constants."""
    rl = mod(pkg, "core.roofline")
    if pkg == "repro_torch":
        kw["hw"] = rl.V5E
    return rl.roofline_row(record, **kw)


# ------------------------------------------- the reference's nine cases
@pytest.mark.parametrize("pkg", PACKAGES)
class TestHLOParser:
    def test_computations_parsed(self, pkg):
        comps = mod(pkg, "core.hlo").parse_computations(HLO)
        assert "main" in comps and "inner_body" in comps

    def test_loop_corrected_totals(self, pkg):
        _, totals = mod(pkg, "core.hlo").collect_collectives(HLO)
        block = 128 * 256 * 2  # bf16[128,256]
        assert totals["all-reduce"] == block          # once in entry
        assert totals["all-gather"] == 32 * block     # x trip count

    def test_schedule_order_and_bytes(self, pkg):
        sched = mod(pkg, "core.hlo").collective_schedule(HLO)
        kinds = [k for k, _ in sched]
        assert kinds == ["all-reduce", "all-gather"]
        assert all(b == 128 * 256 * 2 for _, b in sched)


@pytest.mark.parametrize("pkg", PACKAGES)
class TestJobGraphExtraction:
    def test_graph_from_schedule(self, pkg):
        g = mod(pkg, "core.hlo_extract").step_job_graph(
            HLO, n_nodes=4, total_work=100.0, skew=0.2, seed=1)
        assert len(g.nodes) == 4
        g.topological_order()  # valid DAG
        # every collective became a barrier level
        assert g.stats()["depth_levels"] >= 2

    def test_schedulable(self, pkg):
        core = mod(pkg, "core")
        g = mod(pkg, "core.hlo_extract").step_job_graph(
            HLO, n_nodes=3, total_work=30.0, skew=0.3)
        specs = core.homogeneous_cluster(3)
        P = sum(s.lut.idle_w + 0.3 * (s.lut.p_min - s.lut.idle_w)
                for s in specs)
        res = core.compare_policies(g, specs, P)
        assert res["heuristic"].makespan > 0


@pytest.mark.parametrize("pkg", PACKAGES)
class TestRooflineModel:
    def test_flops_scale_with_tokens(self, pkg):
        rl = mod(pkg, "core.roofline")
        cfg = mod(pkg, "configs").get_config("llama3-8b")
        f_train = rl.analytic_flops(cfg, TRAIN_4K)
        f_prefill = rl.analytic_flops(cfg, PREFILL_32K)
        # train is 3x prefill per token (fwd+bwd) + remat
        per_tok_train = f_train["model_flops"] / TRAIN_4K.tokens
        per_tok_prefill = f_prefill["model_flops"] / PREFILL_32K.tokens
        assert per_tok_train == pytest.approx(3 * per_tok_prefill)

    def test_moe_uses_active_params(self, pkg):
        cfg = mod(pkg, "configs").get_config("arctic-480b")
        f = mod(pkg, "core.roofline").analytic_flops(cfg, TRAIN_4K)
        assert f["model_flops"] == pytest.approx(
            6.0 * cfg.active_param_count() * TRAIN_4K.tokens)

    def test_decode_bytes_dominated_by_kv(self, pkg):
        cfg = mod(pkg, "configs").get_config("qwen1.5-4b")  # MHA cache
        b = mod(pkg, "core.roofline").analytic_bytes(cfg, DECODE_32K)
        assert b["act_bytes"] > b["weight_bytes"]

    def test_roofline_row_from_artifact(self, pkg):
        r = row(pkg, ARTIFACT)
        assert r.dominant in ("compute", "memory", "collective")
        assert 0 < r.roofline_fraction <= 1.0
        assert r.coll_bytes_per_dev == pytest.approx((2 * 10 + 5) * 2**20)


# ----------------------------------------------------- port vs reference
def test_parser_matches_reference():
    from repro.core import hlo as ref

    from repro_torch.core import hlo as port
    assert port.collective_schedule(HLO) == ref.collective_schedule(HLO)
    ops, totals = port.collect_collectives(HLO)
    r_ops, r_totals = ref.collect_collectives(HLO)
    assert totals == r_totals
    assert [dataclasses.astuple(o) for o in ops] == \
        [dataclasses.astuple(o) for o in r_ops]


@pytest.mark.parametrize("n_nodes,skew,seed,max_segments",
                         [(4, 0.2, 1, 64), (16, 0.15, 0, 64),
                          (3, 0.0, 7, 1)])
def test_graph_from_text_equals_graph_from_schedule(n_nodes, skew, seed,
                                                    max_segments):
    """The port's graph from HLO text, the port's from that text's
    schedule, and the reference's from the text are one graph."""
    from repro.core.hlo_extract import step_job_graph as ref_graph

    kw = dict(n_nodes=n_nodes, skew=skew, seed=seed,
              max_segments=max_segments)
    from_text = hlo_extract.step_job_graph(HLO, **kw)
    from_sched = hlo_extract.step_job_graph(collective_schedule(HLO), **kw)
    assert graph_key(from_text) == graph_key(from_sched) == \
        graph_key(ref_graph(HLO, **kw))
    assert hlo_extract.describe_schedule(HLO) == \
        hlo_extract.describe_schedule(collective_schedule(HLO))


def test_long_schedule_keeps_largest_collectives():
    """Past ``max_segments`` the largest collectives stay, in program
    order: the graph is the one of the kept sub-schedule."""
    sched = [("all-reduce", 8), ("all-gather", 64), ("all-to-all", 4),
             ("reduce-scatter", 32), ("collective-permute", 16)]
    kept = [sched[1], sched[3], sched[4]]
    g = hlo_extract.step_job_graph(sched, n_nodes=2, max_segments=3)
    assert graph_key(g) == graph_key(hlo_extract.step_job_graph(kept,
                                                                n_nodes=2))
    assert len(g.jobs) == 2 * 4


def _artifacts():
    """One artifact per runnable cell and mesh, with collective totals
    that differ by kind."""
    out = []
    for arch in ARCH_IDS:
        for shape in ALL_SHAPES:
            if cell_status(arch, shape.name) != "run":
                continue
            for mesh, n in (("pod16x16", 256), ("pod2x16x16", 512)):
                out.append({
                    "arch": arch, "shape": shape.name, "mesh": mesh,
                    "n_devices": n, "peak_bytes_per_device": 3 * 2**30,
                    "cost": {"flops": 2.5e13},
                    "collectives_per_device": {
                        "all-gather": {"count": 3, "bytes": 7 * 2**20},
                        "all-to-all": {"count": 1, "bytes": 2**20}},
                    "collectives_per_device_loop_corrected": {
                        "all-reduce": 11 * 2**20, "all-gather": 7 * 2**20,
                        "reduce-scatter": 3 * 2**20},
                    "n_microbatches": 2 if shape.kind == "train" else 1})
    return out


def test_roofline_rows_match_reference_under_v5e():
    """Every runnable cell's row, under the reference's constants, equals
    the reference's field for field (floats at rtol 1e-12); the analytic
    FLOPs and bytes are equal exactly."""
    from repro.configs import get_config as ref_config
    from repro.core import roofline as ref

    arts = _artifacts()
    assert len(arts) == 2 * 31
    for rec in arts:
        ours = dataclasses.asdict(row("repro_torch", rec))
        theirs = dataclasses.asdict(ref.roofline_row(rec))
        for key, val in theirs.items():
            if isinstance(val, float):
                np.testing.assert_allclose(ours[key], val, rtol=1e-12,
                                           err_msg=f"{rec['arch']} {key}")
            else:
                assert ours[key] == val, (rec["arch"], key)
        no_lc = dict(rec)
        del no_lc["collectives_per_device_loop_corrected"]
        assert row("repro_torch", no_lc).collective_s == \
            ref.roofline_row(no_lc).collective_s
        cfg, shape = get_config(rec["arch"], rec["shape"]), rec["shape"]
        from repro_torch.configs.base import shape_by_name
        sh = shape_by_name(shape)
        rcfg = ref_config(rec["arch"], rec["shape"])
        assert roofline.analytic_flops(cfg, sh) == \
            ref.analytic_flops(rcfg, sh)
        assert roofline.analytic_bytes(cfg, sh, n_micro=2) == \
            ref.analytic_bytes(rcfg, sh, n_micro=2)


def test_h100_set_scales_each_term():
    """The H100 row's terms are the v5e row's times the ratio of the
    peaks; only the hardware set differs."""
    v5e = roofline.roofline_row(ARTIFACT, hw=roofline.V5E)
    h100 = roofline.roofline_row(ARTIFACT)
    hw = roofline.H100
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw) == (989e12, 3.35e12, 50e9)
    assert roofline.NVLINK_BW == 450e9
    np.testing.assert_allclose(h100.compute_s,
                               v5e.compute_s * 197e12 / 989e12, rtol=1e-12)
    np.testing.assert_allclose(h100.memory_s,
                               v5e.memory_s * 819e9 / 3.35e12, rtol=1e-12)
    assert h100.collective_s == v5e.collective_s
    assert h100.model_flops == v5e.model_flops


def test_model_flops_share_is_the_hand_formula():
    """``model_flops_share`` is the card script's ``6 N T / (wall *
    989e12)``, bit for bit."""
    for n, t, wall in [(8.03e9, 8192, 0.167), (2.7e9 * 12 / 54, 4096, 0.2),
                       (1.0, 1.0, 1.0)]:
        assert roofline.model_flops_share(n, t, wall) == \
            6 * n * t / (wall * 989e12)


def test_build_table_and_cli(tmp_path, capsys):
    """``build_table`` reads a directory of artifacts for one mesh; the
    module's CLI prints the H100 table by default."""
    for rec in _artifacts()[:6]:
        name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
        (tmp_path / name).write_text(json.dumps(rec))
    rows = roofline.build_table(str(tmp_path))
    assert len(rows) == 3 and {r.mesh for r in rows} == {"pod16x16"}
    assert rows[0] == roofline.roofline_row(
        roofline.load_records(str(tmp_path))[0])
    assert roofline.main([str(tmp_path), "--mesh", "pod2x16x16"]) == 0
    out = capsys.readouterr().out
    assert "h100-sxm" in out and out.count("\n") == 1 + 2 + 3
