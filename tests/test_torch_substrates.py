"""The port's training substrates against the JAX reference's: each case of
``tests/test_substrates.py`` on ``repro_torch`` (optimizer for each state
type, int8 against fp32, clipping, the lr schedule, the quantize round
trip, error feedback, data determinism and disjointness, encoder frames,
checkpoint atomicity, retention, crash mid-write, structure mismatch and
device restore), plus:

* ``adamw_update`` against the reference's on a model's leaves carried
  across (llama3-8b smoke, fp32 parameters), three steps from one numpy
  seed's gradients, each from the reference's parameters and state, for
  fp32, bf16 and int8 state.  Both run the same fp32 formulas leaf by
  leaf; XLA may fuse and reorder them, so the parameters are held at rtol
  1e-6 (a few fp32 ulps of one step) and the moments at their type's bar: fp32 at rtol 1e-6, bf16 within one
  bf16 ulp (2^-7 relative: an fp32 ulp of difference can flip a
  rounding), both with an atol of 1e-6 of the leaf's largest moment (the
  EMA of random gradients cancels to near zero in places, where an fp32
  ulp of the inputs is a large share of the value), int8 within one code
  of its row's scale;
* the data pipeline byte for byte (same values and dtypes) for several
  configs, steps and hosts, the skewed and encoder batches included;
* checkpoints of bf16 and int8 leaves restored bit for bit.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro import models as ref_models  # noqa: E402
from repro.data import pipeline as ref_pipeline  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import compression as ref_compression  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.convert import (opt_state_from_reference,  # noqa: E402
                                 params_from_reference)
from repro_torch.data.pipeline import (DataConfig, global_batch,  # noqa: E402
                                       host_batch, skewed_host_batch)
from repro_torch.optim import (AdamWConfig, QTensor,  # noqa: E402
                               adamw_update, clip_by_global_norm,
                               compression, global_norm, init_opt_state,
                               lr_schedule)
from repro_torch.optim.adamw import (_dequantize_blockwise,  # noqa: E402
                                     _quantize_blockwise)


# ---------------------------------------------------------------- optimizer
def quad_params():
    return {"w": torch.tensor([1.5, -2.0, 0.5]),
            "b": torch.tensor([[0.3, -0.7], [1.1, 0.0]])}


class TestAdamW:
    @pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
    def test_converges_on_quadratic(self, state_dtype):
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                          total_steps=200, min_lr_frac=1.0,
                          state_dtype=state_dtype)
        params = quad_params()
        state = init_opt_state(params, cfg)
        for step in range(150):
            grads = {k: 2 * p for k, p in params.items()}  # d/dp p^2
            adamw_update(params, grads, state, step, cfg)
        norm = float(global_norm(params))
        assert norm < 0.05, f"{state_dtype}: |params|={norm}"

    def test_int8_tracks_fp32(self):
        """int8 moments stay close to the fp32 trajectory."""
        cfg32 = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                            min_lr_frac=1.0, state_dtype="float32")
        cfg8 = AdamWConfig(lr=0.05, weight_decay=0.0, warmup_steps=0,
                           min_lr_frac=1.0, state_dtype="int8")
        p32 = {"w": torch.full((8, 256), 2.0)}
        p8 = {"w": torch.full((8, 256), 2.0)}
        s32 = init_opt_state(p32, cfg32)
        s8 = init_opt_state(p8, cfg8)
        rng = np.random.default_rng(0)
        for step in range(30):
            noise = torch.as_tensor(0.01 * rng.standard_normal((8, 256)),
                                    dtype=torch.float32)
            adamw_update(p32, {"w": 2 * p32["w"] + noise}, s32, step, cfg32)
            adamw_update(p8, {"w": 2 * p8["w"] + noise}, s8, step, cfg8)
        diff = float((p32["w"] - p8["w"]).abs().max())
        assert diff < 0.1, f"int8 diverged from fp32 by {diff}"

    def test_grad_clipping(self):
        grads = {"w": torch.full((4,), 100.0)}
        clipped, norm = clip_by_global_norm(grads, 1.0)
        assert float(norm) == pytest.approx(200.0)
        assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)

    def test_lr_schedule_shape(self):
        cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_frac=0.1)
        assert float(lr_schedule(cfg, 0)) == pytest.approx(0.0)
        assert float(lr_schedule(cfg, 10)) == pytest.approx(1.0)
        end = float(lr_schedule(cfg, 100))
        assert end == pytest.approx(0.1, rel=1e-3)

    @pytest.mark.parametrize("seed", range(6))
    def test_quantize_roundtrip_bounded(self, seed):
        x = torch.as_tensor(
            3.0 * np.random.default_rng(seed).standard_normal((7, 130)),
            dtype=torch.float32)
        codes, scale = _quantize_blockwise(x)
        back = _dequantize_blockwise(codes, scale, x.shape)
        err = float((back - x).abs().max())
        assert err <= float(x.abs().max()) / 127.0 + 1e-6

    @pytest.mark.parametrize("seed", range(3))
    def test_quantize_matches_reference(self, seed):
        """Codes equal and scales bit-equal to the reference's, a 0-dim
        leaf and a stacked one included."""
        rng = np.random.default_rng(seed)
        for shape in ((), (5,), (7, 130), (3, 4, 33)):
            x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
            codes, scale = _quantize_blockwise(torch.as_tensor(x))
            rc, rs = ref_adamw._quantize_blockwise(jnp.asarray(x))
            np.testing.assert_array_equal(codes.numpy(), np.asarray(rc))
            np.testing.assert_array_equal(scale.numpy(), np.asarray(rs))


class TestCompression:
    def test_error_feedback_preserves_sum(self):
        """Over many steps, compressed grads sum to the true sum (EF)."""
        g_true = torch.as_tensor(
            np.random.default_rng(1).standard_normal(64), dtype=torch.float32)
        err = compression.init_error_feedback({"g": g_true})
        total_hat = torch.zeros(64)
        for _ in range(50):
            ghat, err_g = compression.compress_decompress(g_true, err["g"])
            err = {"g": err_g}
            total_hat = total_hat + ghat
        np.testing.assert_allclose((total_hat / 50).numpy(), g_true.numpy(),
                                   atol=0.05)

    def test_apply_matches_reference(self):
        """``apply`` against the reference's on one numpy seed's
        gradients and error state, three rounds: ĝ and the new error equal
        to fp32 rounding (XLA may fuse the divide and multiply)."""
        rng = np.random.default_rng(2)
        grads = {k: rng.standard_normal(s).astype(np.float32)
                 for k, s in (("a", (8, 16)), ("b", (5,)))}
        err_p = compression.init_error_feedback(
            {k: torch.as_tensor(v) for k, v in grads.items()})
        err_r = ref_compression.init_error_feedback(
            {k: jnp.asarray(v) for k, v in grads.items()})
        for _ in range(3):
            g_p, err_p = compression.apply(
                {k: torch.as_tensor(v) for k, v in grads.items()}, err_p)
            g_r, err_r = ref_compression.apply(
                {k: jnp.asarray(v) for k, v in grads.items()}, err_r)
            for k in grads:
                np.testing.assert_allclose(g_p[k].numpy(), np.asarray(g_r[k]),
                                           rtol=1e-6, atol=1e-6)
                np.testing.assert_allclose(err_p[k].numpy(),
                                           np.asarray(err_r[k]),
                                           rtol=1e-6, atol=1e-6)


# ---------------------------------------------------- adamw vs reference
def _ref_tree_to_named(cfg, tree):
    """A reference parameter-shaped tree -> {port name: fp32 tensor}."""
    return {k: p.detach() for k, p in params_from_reference(
        cfg, tree).named_parameters()}


def _check_state(state, want_state, state_dtype):
    for name in want_state:
        for key in ("m", "v"):
            got, ref = state[name][key], want_state[name][key]
            if state_dtype == "int8":
                assert isinstance(got, QTensor)
                np.testing.assert_allclose(got.scale.numpy(),
                                           ref.scale.numpy(), rtol=1e-6)
                codes = (got.codes.int() - ref.codes.int()).abs()
                assert int(codes.max()) <= 1, (name, key)
            else:
                assert got.dtype == ref.dtype
                bar = 1e-6 if state_dtype == "float32" else 2 ** -7
                w = ref.float().numpy()
                np.testing.assert_allclose(
                    got.float().numpy(), w, rtol=bar,
                    atol=1e-6 * float(np.abs(w).max()), err_msg=name)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_update_matches_reference(state_dtype):
    """Three AdamW steps on llama3-8b smoke's leaves (see the module doc
    for the bars), with clipping active (grad_clip below the norm) and a
    microbatch grad_scale.  Each step starts both sides from the
    reference's parameters and state: a flipped rounding of a bf16 or
    int8 moment is one ulp or code of the state, and would otherwise move
    the later updates by more than fp32 rounding."""
    rcfg = ref_configs.get_smoke("llama3-8b")
    pcfg = configs.get_smoke("llama3-8b")
    opt = AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                      grad_clip=5.0, state_dtype=state_dtype)
    ref_opt = ref_adamw.AdamWConfig(**opt.__dict__)
    ref_params = ref_models.init_params(rcfg, jax.random.PRNGKey(0))
    ref_state = ref_adamw.init_opt_state(ref_params, ref_opt)
    rng = np.random.default_rng(5)
    for step in range(3):
        params = _ref_tree_to_named(pcfg, ref_params)
        state = opt_state_from_reference(pcfg, ref_state)
        leaves, treedef = jax.tree_util.tree_flatten(ref_params)
        ref_grads = jax.tree_util.tree_unflatten(treedef, [
            jnp.asarray(rng.standard_normal(np.shape(x)).astype(np.float32))
            for x in leaves])
        ref_params, ref_state, ref_m = ref_adamw.adamw_update(
            ref_params, ref_grads, ref_state, jnp.int32(step), ref_opt,
            grad_scale=0.5)
        _, _, metrics = adamw_update(params, _ref_tree_to_named(
            pcfg, ref_grads), state, step, opt, grad_scale=0.5)
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(metrics["lr"]), float(ref_m["lr"]),
                                   rtol=1e-6)
        want = _ref_tree_to_named(pcfg, ref_params)
        for name, p in params.items():
            np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=name)
        _check_state(state, opt_state_from_reference(pcfg, ref_state),
                     state_dtype)


def test_stacked_leaf_updates_slice_by_slice(monkeypatch):
    """A leaf of ndim >= 3 past ``CHUNK_ELEMS`` is updated one slice at a
    time, in place, to the values the whole-leaf update gives (the
    threshold lowered so a small leaf takes that path)."""
    from repro_torch.optim import adamw as port_adamw

    rng = np.random.default_rng(3)
    w = rng.standard_normal((4, 6, 8)).astype(np.float32)
    g = rng.standard_normal((4, 6, 8)).astype(np.float32)
    for sd in ("float32", "bfloat16", "int8"):
        cfg = AdamWConfig(lr=0.1, warmup_steps=0, state_dtype=sd)
        out = []
        for chunk in (1 << 40, 100):
            monkeypatch.setattr(port_adamw, "CHUNK_ELEMS", chunk)
            p = {"w": torch.as_tensor(w.copy())}
            st = init_opt_state(p, cfg)
            ptr = p["w"].data_ptr()
            for step in range(2):
                adamw_update(p, {"w": torch.as_tensor(g)}, st, step, cfg)
            assert p["w"].data_ptr() == ptr
            out.append(p["w"])
        torch.testing.assert_close(out[0], out[1], rtol=0, atol=0)


# --------------------------------------------------------------------- data
class TestDataPipeline:
    CFG = DataConfig(vocab=1000, seq_len=64, global_batch=8, seed=3)

    def test_deterministic(self):
        a = host_batch(self.CFG, step=5, host=0, n_hosts=2)
        b = host_batch(self.CFG, step=5, host=0, n_hosts=2)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])

    def test_hosts_disjoint_streams(self):
        a = host_batch(self.CFG, step=5, host=0, n_hosts=2)
        b = host_batch(self.CFG, step=5, host=1, n_hosts=2)
        assert not np.array_equal(a["tokens"], b["tokens"])

    def test_steps_differ(self):
        a = host_batch(self.CFG, step=1, host=0, n_hosts=2)
        b = host_batch(self.CFG, step=2, host=0, n_hosts=2)
        assert not np.array_equal(a["tokens"], b["tokens"])

    def test_global_assembly(self):
        g = global_batch(self.CFG, step=0, n_hosts=2)
        assert g["tokens"].shape == (8, 64)
        assert g["labels"].shape == (8, 64)
        t, l = g["tokens"], g["labels"]
        inner = (t[:, 1:] == l[:, :-1]) | (l[:, :-1] == -1)
        assert inner.mean() > 0.95

    def test_skewed_host_has_more_work(self):
        a = host_batch(self.CFG, 0, 0, 2)
        s = skewed_host_batch(self.CFG, 0, 0, 2, skew_host=0)
        assert (s["tokens"] == self.CFG.pad_id).sum() <= \
            (a["tokens"] == self.CFG.pad_id).sum()

    def test_encoder_family_frames(self):
        cfg = DataConfig(vocab=32, seq_len=16, global_batch=4,
                         family="encoder", d_model=24)
        b = host_batch(cfg, 0, 0, 1)
        assert b["frames"].shape == (4, 16, 24)
        assert b["labels"].shape == (4, 16)

    @pytest.mark.parametrize("kw", [
        dict(vocab=1000, seq_len=64, global_batch=8, seed=3),
        dict(vocab=128256, seq_len=512, global_batch=4, seed=0,
             mean_doc_len=64),
        dict(vocab=32, seq_len=16, global_batch=4, family="encoder",
             d_model=24, seed=7)])
    def test_byte_equal_to_reference(self, kw):
        """The same config, step and host: the same arrays, values and
        dtypes, as the reference's (global, host and skewed batches)."""
        cfg, ref = DataConfig(**kw), ref_pipeline.DataConfig(**kw)
        for step in (0, 3, 17):
            pairs = [(global_batch(cfg, step, 2),
                      ref_pipeline.global_batch(ref, step, 2))]
            for host in (0, 1):
                pairs.append((host_batch(cfg, step, host, 2),
                              ref_pipeline.host_batch(ref, step, host, 2)))
                pairs.append((skewed_host_batch(cfg, step, host, 2, 1),
                              ref_pipeline.skewed_host_batch(ref, step, host,
                                                             2, 1)))
            for got, want in pairs:
                assert sorted(got) == sorted(want)
                for k in got:
                    assert got[k].dtype == want[k].dtype
                    assert got[k].tobytes() == want[k].tobytes()


# --------------------------------------------------------------- checkpoint
class TestCheckpoint:
    def make_tree(self, scale=1.0):
        return {"params": {"w": torch.full((4, 8), scale),
                           "b": torch.arange(3.0) * scale},
                "opt": {"m": torch.zeros((4, 8))}}

    def test_save_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last=2)
        tree = self.make_tree(2.0)
        mgr.save(7, tree, extra={"loss": 1.25})
        restored, step, extra = mgr.restore(self.make_tree(0.0))
        assert step == 7 and extra["loss"] == 1.25
        torch.testing.assert_close(restored["params"]["w"],
                                   tree["params"]["w"], rtol=0, atol=0)

    def test_retention(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, self.make_tree(float(s)))
        assert mgr.completed_steps() == [3, 4]

    def test_crash_mid_write_ignored(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep_last=2)
        mgr.save(1, self.make_tree(1.0))
        crash = tmp_path / "step_000000002.tmp-deadbeef"
        crash.mkdir()
        (crash / "leaf_00000.npy").write_bytes(b"garbage")
        assert mgr.latest_step() == 1
        _, step, _ = mgr.restore(self.make_tree(0.0))
        assert step == 1
        mgr.save(3, self.make_tree(3.0))  # gc cleans the crash dir
        assert not crash.exists()

    def test_structure_mismatch_rejected(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, self.make_tree())
        bad = {"params": {"w": torch.zeros((4, 8))}}  # missing leaves
        with pytest.raises(ValueError):
            mgr.restore(bad)

    def test_restore_onto_device(self, tmp_path):
        """``restore(..., device=)`` places every leaf there (the
        counterpart of the reference's ``shardings``); the meta device
        stands in for another device."""
        mgr = CheckpointManager(str(tmp_path))
        tree = self.make_tree(5.0)
        mgr.save(2, tree)
        restored, step, _ = mgr.restore(self.make_tree(0.0), device="cpu")
        assert step == 2 and restored["params"]["w"].device.type == "cpu"
        meta = {"params": {"w": torch.empty((4, 8), device="meta"),
                           "b": torch.empty(3, device="meta")},
                "opt": {"m": torch.empty((4, 8), device="meta")}}
        on_meta, _, _ = mgr.restore(meta)
        assert on_meta["opt"]["m"].device.type == "meta"
        back, _, _ = mgr.restore(meta, device="cpu")
        torch.testing.assert_close(back["params"]["b"], tree["params"]["b"],
                                   rtol=0, atol=0)

    def test_bf16_and_int8_bit_for_bit(self, tmp_path):
        """bf16 leaves (numpy has no bf16: stored as their 16-bit
        patterns) and int8 moments come back bit for bit, types kept; the
        paths carry the state_dict / optimizer names."""
        rng = np.random.default_rng(0)
        w = torch.as_tensor(rng.standard_normal((6, 5)),
                            dtype=torch.float32).to(torch.bfloat16)
        w[0, 0] = float("nan")
        w[0, 1] = -0.0
        cfg = AdamWConfig(state_dtype="int8")
        params = {"blocks.0.w": torch.nn.Parameter(w.clone())}
        st = init_opt_state(params, cfg)
        adamw_update(params, {"blocks.0.w": torch.ones_like(w)}, st, 0, cfg)
        tree = {"params": {k: p.detach() for k, p in params.items()},
                "opt": st}
        mgr = CheckpointManager(str(tmp_path))
        path = mgr.save(0, tree)
        import json
        manifest = json.loads((path / "manifest.json").read_text())
        assert manifest["paths"] == ["params/blocks.0.w",
                                     "opt/blocks.0.w/m/codes",
                                     "opt/blocks.0.w/m/scale",
                                     "opt/blocks.0.w/v/codes",
                                     "opt/blocks.0.w/v/scale"]
        assert manifest["dtypes"][0] == "bfloat16"
        template = {"params": {"blocks.0.w": torch.zeros_like(w)},
                    "opt": init_opt_state(params, cfg)}
        got, _, _ = mgr.restore(template)
        g = got["params"]["blocks.0.w"]
        assert g.dtype == torch.bfloat16
        assert torch.equal(g.view(torch.int16),
                           params["blocks.0.w"].detach().view(torch.int16))
        for key in ("m", "v"):
            assert isinstance(got["opt"]["blocks.0.w"][key], QTensor)
            for a, b in zip(got["opt"]["blocks.0.w"][key],
                            st["blocks.0.w"][key]):
                assert a.dtype == b.dtype and torch.equal(a, b)
