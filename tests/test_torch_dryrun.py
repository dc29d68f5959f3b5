"""The port's dry run on a fake mesh (``repro_torch.launch.dryrun``), its
activation policy (``repro_torch.models.sharding``), the LM kernels'
sharded operators (``repro_torch.kernels.sharded``) and the
sequence-sharded flash decoding, against the reference where it has a
counterpart.

The reference's own dry run of ``xlstm-350m x decode_32k`` fails under
jax 0.9.0 (``with_sharding_constraint can only refer to Auto axes``), so
the CLI test checks the port's artifact on its own: its schema and that
its numbers are consistent."""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as ref_attn

from repro_torch.core.hlo_extract import step_job_graph
from repro_torch.kernels import ops
from repro_torch.launch.mesh import alltoall_redistribution, production_mesh
from repro_torch.models import attention as port_attn
from repro_torch.models import sharding as msh

ROOT = Path(__file__).resolve().parents[1]


# ------------------------------------------------- flash decoding, 4 ranks
def _threaded(world_size, fn):
    """``fn(rank)`` on ``world_size`` threads, each a rank of one threaded
    process group; returns {rank: result}, raising the first error."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.multi_threaded_pg import (
        _install_threaded_pg, _uninstall_threaded_pg)

    results, errors = {}, []
    torch._C._distributed_c10d._set_thread_isolation_mode(True)
    world = _install_threaded_pg()
    store = dist.HashStore()

    def worker(rank):
        dist.init_process_group("threaded", rank=rank,
                                world_size=world_size, store=store)
        try:
            results[rank] = fn(rank)
        except BaseException as err:  # noqa: BLE001 — re-raised below
            errors.append(err)
        finally:
            if world == dist.distributed_c10d._world:
                dist.destroy_process_group()

    try:
        threads = [threading.Thread(target=worker, args=(r,))
                   for r in range(world_size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        _uninstall_threaded_pg()
        torch._C._distributed_c10d._set_thread_isolation_mode(False)
    if errors:
        raise errors[0]
    return results


def _ref_decode(q, k_cache, v_cache, new_k, new_v, pos, window):
    """The reference's single-device decode attention (its
    ``attention_decode`` without a policy): the new key and value written
    at ``pos``, then ``gqa_attend`` under the position mask."""
    kc = jnp.asarray(k_cache).at[:, pos].set(jnp.asarray(new_k[:, 0]))
    vc = jnp.asarray(v_cache).at[:, pos].set(jnp.asarray(new_v[:, 0]))
    kpos = jnp.arange(k_cache.shape[1])
    keep = kpos <= pos
    if window > 0:
        keep &= kpos > (pos - window)
    b = q.shape[0]
    keep = jnp.broadcast_to(keep[None, None, :], (b, 1, k_cache.shape[1]))
    out = ref_attn.gqa_attend(jnp.asarray(q), kc, vc, keep,
                              decode_layout=True)
    return np.asarray(out), np.asarray(kc), np.asarray(vc)


@pytest.mark.parametrize("pos,window", [(0, 0), (5, 0), (13, 0), (11, 6),
                                        (15, 3)])
def test_seqsharded_decode_matches_reference(pos, window):
    """``decode_attend_seqsharded`` on a real 2x2 mesh (batch over data,
    the cache's 16 positions over model, 8 a rank) against the
    reference's single-device decode, fp32 at rtol 1e-5; the cache write
    lands on the owning shard only."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    rng = np.random.default_rng(pos * 7 + window)
    b, s, hkv, h, dh = 4, 16, 2, 4, 8
    q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
    kc, vc = (rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
              for _ in range(2))
    nk, nv = (rng.standard_normal((b, 1, hkv, dh)).astype(np.float32)
              for _ in range(2))
    want, want_k, want_v = _ref_decode(q, kc, vc, nk, nv, pos, window)

    def rank_fn(rank):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        msh.set_policy(mesh, "data")
        try:
            batch = [Shard(0), Replicate()]
            seq = [Shard(0), Shard(1)]
            dq, dnk, dnv = (distribute_tensor(torch.from_numpy(a), mesh,
                                              batch) for a in (q, nk, nv))
            dk, dv = (distribute_tensor(torch.from_numpy(a), mesh, seq)
                      for a in (kc, vc))
            assert port_attn._seqsharded_available(dk)
            out = port_attn.decode_attend_seqsharded(dq, dk, dv, dnk, dnv,
                                                     pos, window=window)
            return (out.full_tensor().numpy(), dk.full_tensor().numpy(),
                    dv.full_tensor().numpy(), tuple(out.placements))
        finally:
            msh.clear_policy()

    results = _threaded(4, rank_fn)
    assert len(results) == 4
    for out, k_all, v_all, placements in results.values():
        np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(k_all, want_k)
        np.testing.assert_array_equal(v_all, want_v)
        assert placements == (Shard(0), Replicate())


# ----------------------------------------------------------- fake mesh
@pytest.fixture
def mesh():
    with production_mesh() as m:
        yield m


def _fake_dtensor(mesh, fake, shape, placements, dtype=torch.float32,
                  requires_grad=False):
    from repro_torch.launch.dryrun import _shard

    t = _shard(torch.empty(shape, dtype=dtype, device="meta"), mesh,
               placements, fake)
    return t.requires_grad_(requires_grad) if requires_grad else t


def _cost():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import StepCost

    fake = FakeTensorMode(allow_non_fake_inputs=True)
    return fake, StepCost(fake)


def test_shard_to_shard_is_recorded_as_all_to_all(mesh):
    """A ``Shard(0) -> Shard(1)`` redistribution over the model axis is
    logged as one all-to-all of the local result's bytes; without the dry
    run's counting it would be DTensor's CPU fallback, an all-gather of
    the whole dim."""
    from torch.distributed.tensor import Replicate, Shard

    fake, cost = _cost()
    x = _fake_dtensor(mesh, fake, (64, 256, 32), [Replicate(), Shard(0)])
    with cost, alltoall_redistribution():
        y = x.redistribute(mesh, [Replicate(), Shard(1)])
    assert tuple(y.to_local().shape) == (64, 16, 32)
    assert cost.schedule == [("all-to-all", 64 * 16 * 32 * 4)]
    fake, plain = _cost()
    x = _fake_dtensor(mesh, fake, (64, 256, 32), [Replicate(), Shard(0)])
    with plain:
        x.redistribute(mesh, [Replicate(), Shard(1)])
    assert [k for k, _ in plain.schedule] == ["all-gather"]


def test_kernel_ops_shard_by_rule(mesh):
    """The LM kernels' operators on DTensors: rmsnorm keeps a row split,
    attention a batch and sequence split (K/V whole), the scan a batch and
    head split, each with no collective; the backward of the norm leaves
    dgamma a partial sum; the FLOPs are the registered formulas'."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    fake, cost = _cost()
    x = _fake_dtensor(mesh, fake, (32, 256, 64), [Shard(0), Shard(1)],
                      requires_grad=True)
    g = _fake_dtensor(mesh, fake, (64,), [Replicate(), Replicate()],
                      requires_grad=True)
    q = _fake_dtensor(mesh, fake, (32, 256, 16, 8), [Shard(0), Shard(1)])
    kv = _fake_dtensor(mesh, fake, (32, 256, 16, 8), [Shard(0), Replicate()])
    xs = _fake_dtensor(mesh, fake, (32, 16, 256, 8), [Shard(0), Shard(1)])
    a = _fake_dtensor(mesh, fake, (32, 16, 256), [Shard(0), Shard(1)])
    bm = _fake_dtensor(mesh, fake, (32, 256, 4), [Shard(0), Replicate()])
    with cost:
        y = ops.rmsnorm(x, g, eps=1e-5, layer_form=True)
        att = ops.flash_attention(q, kv, kv, causal=True)
        scan = ops.ssm_scan(xs, a, a, bm, bm, chunk=64)
        y.sum().backward()
    assert y.placements == (Shard(0), Shard(1))
    assert att.placements == (Shard(0), Shard(1))
    assert scan.placements == (Shard(0), Shard(1)) and \
        scan.dtype == torch.float32
    assert g.grad is not None and x.grad.placements == (Shard(0), Shard(1))
    kinds = {k for k, _ in cost.schedule}
    assert kinds <= {"all-reduce"}      # dgamma's partial sum, reduced
    # attention: 2 ranks' batch of 32/16, 16 of 256 queries a rank
    assert cost.flops == 4 * 2 * 16 * 16 * 256 * 8 + 6 * 2 * 1 * 256 * 8 * 4
    from repro_torch.kernels import sharded
    assert sharded._rmsnorm_bwd_sharding(
        x, g, x, 1e-5, True, None)[1][0][1] == Partial()


def test_constrain_is_identity_without_policy_or_dtensor(mesh):
    """No policy, or a plain tensor: ``constrain`` returns ``x`` itself,
    so the paths on the card and on the CPU do not change."""
    x = torch.ones(4, 8, 2)
    assert msh.get_policy() is None
    assert msh.constrain(x, "dp", "mdl", None) is x
    msh.set_policy(mesh, "data")
    try:
        assert msh.constrain(x, "dp", "mdl", None) is x
        assert msh.logical_spec(mesh, (32, 48, 2), ("dp", "mdl", None)) \
            == ("data", "model", None)
        assert msh.logical_spec(mesh, (8, 48, 2), ("dp", "mdl", None)) \
            == (None, "model", None)
    finally:
        msh.clear_policy()
    assert msh.get_policy() is None


@pytest.mark.parametrize("arch,shape,multi_pod,layers", [
    ("llama3-8b", "train_4k", False, 1),
    ("moonshot-v1-16b-a3b", "train_4k", False, None),
    ("zamba2-2.7b", "prefill_32k", False, None),
    ("qwen1.5-4b", "decode_32k", False, None),
    ("qwen1.5-4b", "decode_32k", True, None)])
def test_smoke_cells_run(arch, shape, multi_pod, layers, tmp_path,
                         monkeypatch):
    """The dry run's train, prefill and decode paths (microbatches, AdamW,
    the MoE dispatch, the scan, flash attention, the sequence-sharded
    decode) at the smoke configs' widths on the 256-rank mesh (and one on
    the 512-rank one), the cell's shape cut to 64 rows of 2048 positions:
    an artifact with FLOPs, live bytes and a schedule whose kinds are the
    reference's; a depth cut is recorded."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.launch import dryrun

    monkeypatch.setattr(dryrun, "get_config",
                        lambda a, s=None: configs.get_smoke(a))
    monkeypatch.setattr(dryrun, "shape_by_name",
                        lambda s: dataclasses.replace(
                            configs.shape_by_name(s), seq_len=2048,
                            global_batch=64))
    rec = dryrun.run_cell(arch, shape, multi_pod, tmp_path, verbose=False,
                          n_layers=layers)
    mesh = "pod2x16x16" if multi_pod else "pod16x16"
    assert rec["n_devices"] == (512 if multi_pod else 256)
    assert rec["cost"]["flops"] > 0 and rec["mesh"] == mesh
    assert rec["reduced"] == (None if layers is None else
                              f"n_layers {layers} of "
                              f"{configs.get_smoke(arch).n_layers}")
    assert rec["peak_bytes_per_device"] > rec["memory"]["argument_bytes"] > 0
    kinds = {k for k, _ in rec["schedule"]}
    assert kinds and kinds <= {"all-gather", "all-reduce", "reduce-scatter",
                               "all-to-all", "collective-permute"}
    assert json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json")
                      .read_text())["schedule"] == rec["schedule"]


# ----------------------------------------------------------------- CLI
def _run_cli(*args, timeout=600):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=ROOT)


def test_dryrun_cell_subprocess(tmp_path):
    """``--arch xlstm-350m --shape decode_32k --mesh single`` writes the
    artifact: 256 devices, live bytes, FLOPs, both collective keys and
    the schedule they sum; the schedule becomes a job graph."""
    arch, shape = "xlstm-350m", "decode_32k"
    proc = _run_cli("--arch", arch, "--shape", shape, "--mesh", "single",
                    "--out", str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.loads((tmp_path / f"{arch}__{shape}__pod16x16.json")
                     .read_text())
    assert rec["n_devices"] == 256
    assert rec["peak_bytes_per_device"] > 0
    assert rec["cost"].get("flops", 0) > 0
    assert "collectives_per_device_loop_corrected" in rec
    colls = rec["collectives_per_device"]
    assert colls and rec["collectives_per_device_loop_corrected"] == {
        k: v["bytes"] for k, v in colls.items()}
    for kind, v in colls.items():
        sched = [b for k, b in rec["schedule"] if k == kind]
        assert (len(sched), sum(sched)) == (v["count"], v["bytes"])
    g = step_job_graph(rec["schedule"], n_nodes=16, skew=0.15, seed=0)
    assert len(g.nodes) == 16
    g.topological_order()


def test_skip_cell_reports_reason(tmp_path):
    proc = _run_cli("--arch", "hubert-xlarge", "--shape", "decode_32k",
                    "--out", str(tmp_path), timeout=120)
    assert proc.returncode == 0
    assert "skip: encoder-only" in proc.stdout
    assert not list(tmp_path.iterdir())
