"""The hand-written CUDA kernel against its plain PyTorch version, on the
card.  Every test here needs an NVIDIA GPU with ``nvcc`` and skips
elsewhere; the file imports neither ``jax`` nor ``repro``, so it runs on
the GPU machine as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernel_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.backends.engine import TorchBatchSimulator
from repro_torch.core.power import (heterogeneous_cluster, lut_table,
                                    stack_lut_tables)
from repro_torch.core.workloads import listing2_graph, mixed_members
from repro_torch.kernels import power_step as ps

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
