"""The port's fused power step against the JAX reference.

The same numpy inputs (from a seed) go through the reference's
``power_step_ref`` and ``power_step_pallas`` (interpret mode, as
``tests/test_kernels.py`` runs it on the CPU) and through the port's
plain PyTorch version, at the reference's own tolerance
(``rtol = atol = 1e-6``), and against the numpy translation / water-fill
oracles at ``1e-5``.  The CUDA kernel itself is held against the plain
version on the card (``tests/test_torch_kernel_cuda.py``).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import power as ref_power  # noqa: E402
from repro.kernels import power_step as ref_ps  # noqa: E402

from repro_torch.convert import from_reference  # noqa: E402
from repro_torch.core import power as port_power  # noqa: E402
from repro_torch.kernels import power_step as ps  # noqa: E402

TOL = dict(rtol=1e-6, atol=1e-6)


def _shared(n, seed=0):
    table = ref_power.lut_table(ref_power.heterogeneous_cluster(n, seed=seed))
    return table, ref_ps.step_tables(table)


def _stacked(n, rows, seed=0):
    """Per-row clusters of 1..n nodes stacked with phantom lanes."""
    rng = np.random.default_rng(seed)
    tables = [ref_power.lut_table(ref_power.heterogeneous_cluster(
        int(rng.integers(1, n + 1)), seed=int(rng.integers(1 << 16))))
        for _ in range(rows)]
    table = ref_power.stack_lut_tables(tables, n, 10)
    return table, ref_ps.step_tables(table)


def _inputs(table, rows, seed):
    n = table.p_max.shape[-1]
    rng = np.random.default_rng(seed)
    real = np.broadcast_to(table.p_max > 0, (rows, n))
    caps = rng.uniform(0.2, 1.2 * float(table.p_max.max()), (rows, n))
    running = ((rng.random((rows, n)) < 0.7) & real).astype(np.float32)
    remaining = rng.uniform(0.0, 50.0, (rows, n))
    rho = rng.uniform(0.1, 1.0, (rows, n))
    idle = np.broadcast_to(table.idle_w, (rows, n)).sum(-1)
    pmax = np.broadcast_to(table.p_max, (rows, n)).sum(-1)
    bound = rng.uniform(idle, pmax)[:, None]
    return [np.asarray(a, np.float32)
            for a in (caps, running, remaining, rho, bound)]


def _ref_rows(fn, jtab, args, stacked, redistribute):
    """The reference per row (``(1, N)`` / ``(1, 1)``), vmapped over the
    rows (eager: jit would also compile N unrolled water-fill passes)."""
    rows = [jnp.asarray(a)[:, None, :] for a in args]
    tab_axes = ref_ps.StepTables(*([0] * 9)) if stacked else None
    out = jax.vmap(lambda t, c, r, m, h, b: fn(t, c, r, m, h, b,
                                               redistribute=redistribute),
                   in_axes=(tab_axes, 0, 0, 0, 0, 0))(jtab, *rows)
    return [np.asarray(o)[:, 0, :] for o in out]


def _port(ttab, args, redistribute):
    out = ps.power_step(ttab, *(torch.from_numpy(a) for a in args),
                        redistribute=redistribute)
    return [o.numpy() for o in out]


@pytest.mark.parametrize("redistribute", [False, True])
@pytest.mark.parametrize("n", [3, 5, 8, 64])
def test_plain_matches_reference_shared(n, redistribute):
    table, jtab = _shared(n)
    args = _inputs(table, 48, seed=n)
    got = _port(from_reference(jtab), args, redistribute)
    want = _ref_rows(ref_ps.power_step_ref, jtab, args, False, redistribute)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("redistribute", [False, True])
@pytest.mark.parametrize("n", [3, 5, 8, 64])
def test_plain_matches_pallas_interpret(n, redistribute):
    """Pallas in interpret mode, vmapped as the reference engine runs
    it (few rows: the interpreter unrolls N water-fill passes)."""
    table, jtab = _shared(n, seed=1)
    args = _inputs(table, 4, seed=10 + n)
    got = _port(from_reference(jtab), args, redistribute)
    want = _ref_rows(lambda *a, redistribute: ref_ps.power_step_pallas(
        *a, redistribute=redistribute, interpret=True), jtab, args, False,
        redistribute)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("redistribute", [False, True])
@pytest.mark.parametrize("n", [3, 8, 64])
def test_plain_matches_reference_stacked(n, redistribute):
    """Per-row tables with phantom lanes and ragged, +inf padded states;
    the port's own stacking gives the same tables."""
    table, jtab = _stacked(n, 24, seed=n)
    ttab = from_reference(jtab)
    mine = ps.step_tables(from_reference(table))
    for a, b in zip(ttab, mine):
        assert torch.equal(a, b)
    args = _inputs(table, 24, seed=20 + n)
    got = _port(ttab, args, redistribute)
    want = _ref_rows(ref_ps.power_step_ref, jtab, args, True, redistribute)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_stacked_pallas_interpret():
    table, jtab = _stacked(5, 3, seed=3)
    args = _inputs(table, 3, seed=4)
    got = _port(from_reference(jtab), args, True)
    want = _ref_rows(lambda *a, redistribute: ref_ps.power_step_pallas(
        *a, redistribute=redistribute, interpret=True), jtab, args, True,
        True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_translate_matches_numpy_oracle():
    """Translation and rates reproduce the reference's numpy
    ``batched_operating_point`` / ``batched_rates`` on a grid of caps
    with duty states and ragged LUT pads."""
    table, jtab = _shared(5)
    n = table.n_nodes
    rng = np.random.default_rng(7)
    caps = rng.uniform(0.2, 1.2 * float(table.p_max.max()), (16, n))
    freq, duty, power = ref_power.batched_operating_point(table, caps)
    rho = rng.uniform(0.1, 1.0, (16, n))
    rate_np = ref_power.batched_rates(table, freq, duty, rho)
    remaining = rng.uniform(0.1, 50.0, (16, n))
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)  # noqa: E731
    rate, p_node, t_fin, eff, p_cl, t_comp = ps.power_step(
        from_reference(jtab), f32(caps), torch.ones(16, n), f32(remaining),
        f32(rho), torch.ones(16, 1))
    np.testing.assert_allclose(rate.numpy(), rate_np, rtol=1e-5)
    np.testing.assert_allclose(p_node.numpy(), power, rtol=1e-5)
    np.testing.assert_allclose(t_comp.numpy()[:, 0],
                               (remaining / rate_np).min(-1), rtol=1e-4)


@pytest.mark.parametrize("stacked", [False, True])
def test_waterfill_matches_reference_and_oracle(stacked):
    """``waterfill`` agrees with the reference's ``waterfill_caps`` at
    1e-6 and with the numpy ``batched_waterfill`` row for row at 1e-5."""
    from repro.policies.vector import batched_waterfill

    table, jtab = _stacked(6, 32, seed=5) if stacked else _shared(6)
    n = table.p_max.shape[-1]
    rng = np.random.default_rng(9)
    running = (rng.random((32, n)) < 0.6) & np.broadcast_to(
        table.p_max > 0, (32, n))
    budget = rng.uniform(0.0, float(np.broadcast_to(
        table.p_max, (32, n)).sum(-1).max()), 32)
    got = ps.waterfill(from_reference(jtab),
                       torch.tensor(running, dtype=torch.float32),
                       torch.tensor(budget[:, None], dtype=torch.float32))
    tab_axes = ref_ps.StepTables(*([0] * 9)) if stacked else None
    want = jax.vmap(ref_ps.waterfill_caps, in_axes=(tab_axes, 0, 0))(
        jtab, jnp.asarray(running[:, None, :]),
        jnp.asarray(budget[:, None, None], jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:, 0], **TOL)
    oracle = batched_waterfill(running, budget, table)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5)


def test_row_sum_is_the_warp_order():
    """The row sum adds slot by slot per thread, then halves the 32
    threads; in exact arithmetic it is the plain sum."""
    x = torch.arange(1.0, 201.0, dtype=torch.float64).reshape(2, 100)
    assert torch.equal(ps.row_sum(x), x.sum(-1, keepdim=True))
    v = torch.rand(3, 70, dtype=torch.float32)
    pad = torch.nn.functional.pad(v, (0, 26)).view(3, 3, 32)
    acc = pad[:, 0] + pad[:, 1] + pad[:, 2]
    for off in (16, 8, 4, 2, 1):
        acc = acc[:, :off] + acc[:, off:2 * off]
    assert torch.equal(ps.row_sum(v), acc)


def test_dispatch_by_device():
    """CPU tensors take the plain version; asking for the kernel with
    CPU tensors raises instead of falling back."""
    table, jtab = _shared(4)
    ttab = from_reference(jtab)
    args = [torch.from_numpy(a) for a in _inputs(table, 2, seed=0)]
    assert ps.resolve_impl(None, args[0]) == "plain"
    with pytest.raises(ValueError, match="cuda"):
        ps.power_step(ttab, *args, impl="cuda")
    with pytest.raises(ValueError, match="cuda"):
        ps.waterfill(ttab, args[1], args[4], impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ps.power_step(ttab, *args, impl="pallas")


def test_step_tables_layouts():
    """Shared tables keep ``(S, N)`` / ``(1, N)``; stacked ones
    ``(B, S, N)`` / ``(B, N)``; both from the port's own LUT tables."""
    specs = port_power.heterogeneous_cluster(5, seed=2)
    shared = ps.step_tables(port_power.lut_table(specs))
    assert shared.state_p.shape == (10, 5) and shared.p_max.shape == (1, 5)
    assert not shared.stacked
    stacked = ps.step_tables(port_power.stack_lut_tables(
        [port_power.lut_table(specs[:3]), port_power.lut_table(specs)],
        6, 10))
    assert stacked.state_p.shape == (2, 10, 6)
    assert stacked.p_max.shape == (2, 6) and stacked.stacked
    assert float(stacked.p_max[0, 3:].abs().sum()) == 0.0
