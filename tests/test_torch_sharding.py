"""The port's sharding rules (``repro_torch.launch.sharding``) against the
reference's PartitionSpecs, for every config and both production meshes.

The reference's rules are called with a stand-in mesh (``shape`` and
``axis_names`` only), so JAX needs no 256 devices; the port's placements
come from a real DeviceMesh over the fake process group.  Each
parameter, optimizer-state leaf, batch input and decode-cache tensor of
the port must have the placements the reference's spec maps to, and its
per-device bytes (from DTensor's own local-shape rule) must equal the
reference spec's, exactly.  The port keeps a tensor a layer, so a
stacked reference leaf's bytes are the sum of its layers'."""

import functools
import types

import jax
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import sharding as ref_sharding
from repro.launch import steps as ref_steps
from repro.models import abstract_params as ref_abstract_params
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import init_opt_state as ref_init_opt_state

from repro_torch.configs import ARCH_IDS, cell_status, get_config
from repro_torch.configs.base import ALL_SHAPES
from repro_torch.convert import reference_path
from repro_torch.launch import sharding
from repro_torch.launch.mesh import MESHES, production_mesh
from repro_torch.launch.steps import (abstract_cache, abstract_params,
                                      input_specs)
from repro_torch.optim import AdamWConfig, init_opt_state

#: every distinct config of the cells: each arch's, and zamba2's long one
CONFIGS = [(a, None) for a in ARCH_IDS] + [("zamba2-2.7b", "long_500k")]


@pytest.fixture(scope="module", params=sorted(MESHES))
def meshes(request):
    """(the port's DeviceMesh, the reference's stand-in) of one mesh."""
    shape, axes = MESHES[request.param]
    standin = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                    axis_names=axes)
    with production_mesh(multi_pod=len(shape) == 3) as mesh:
        yield mesh, standin


def mapped(standin, spec):
    """A reference spec as DTensor placements, written out here apart
    from the port's own mapping: ``Shard(d)`` on each mesh axis an entry
    on dim ``d`` names, ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard

    out = {a: Replicate() for a in standin.axis_names}
    for dim, entry in enumerate(spec):
        for axis in () if entry is None else (
                (entry,) if isinstance(entry, str) else entry):
            out[axis] = Shard(dim)
    return tuple(out[a] for a in standin.axis_names)


def ref_bytes(standin, spec, shape, itemsize):
    """Per-device bytes of a reference leaf under ``spec``."""
    n = itemsize
    for dim, size in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        ways = 1
        for axis in () if entry is None else (
                (entry,) if isinstance(entry, str) else entry):
            ways *= standin.shape[axis]
        assert size % ways == 0
        n *= size // ways
    return n


def port_bytes(mesh, placements, shape, dtype):
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    local, _ = compute_local_shape_and_global_offset(tuple(shape), mesh,
                                                     placements)
    n = torch.empty((), dtype=dtype).element_size()
    for size in local:
        n *= size
    return n


def ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {ref_sharding.tree_path_of(kp): leaf for kp, leaf in flat}


@functools.lru_cache(maxsize=None)
def port_model(arch, shape):
    return abstract_params(get_config(arch, shape))


@functools.lru_cache(maxsize=None)
def ref_params(arch, shape):
    return ref_abstract_params(ref_config(arch, shape))


def check_leaves(mesh, standin, port, ref, ref_spec):
    """``port``: {reference path: [(placements, shape, dtype), ...]} of
    the port's tensors; ``ref``: {path: leaf}; ``ref_spec(path, leaf)``:
    the reference's spec.  Every path is covered, with the mapped
    placements on its trailing dims and equal per-device bytes."""
    assert set(port) == set(ref)
    for path, tensors in port.items():
        leaf = ref[path]
        spec = tuple(ref_spec(path, leaf))
        total = 0
        for placements, shape, dtype in tensors:
            stack = len(leaf.shape) - len(shape)
            assert tuple(leaf.shape[stack:]) == tuple(shape), path
            assert all(e is None for e in spec[:stack]), (path, spec)
            want = mapped(standin, spec[stack:] + (None,) * (
                len(shape) - len(spec[stack:])))
            assert placements == want, (path, placements, want)
            total += port_bytes(mesh, placements, shape, dtype)
        assert total == ref_bytes(standin, spec, leaf.shape,
                                  leaf.dtype.itemsize), path


@pytest.mark.parametrize("arch,shape", CONFIGS)
def test_param_placements_match_reference(meshes, arch, shape):
    mesh, standin = meshes
    model, cfg = port_model(arch, shape), get_config(arch, shape)
    shard = sharding.param_shardings(cfg, mesh, model)
    port = {}
    for name, p in model.named_parameters():
        port.setdefault(reference_path(name), []).append(
            (shard[name], p.shape, p.dtype))
    rcfg = ref_config(arch, shape)
    check_leaves(mesh, standin, port, ref_leaves(ref_params(arch, shape)),
                 lambda path, leaf: ref_sharding.param_spec(
                     rcfg, standin, path, leaf))


@functools.lru_cache(maxsize=None)
def port_state(arch, shape, state_dtype):
    return init_opt_state(dict(port_model(arch, shape).named_parameters()),
                          AdamWConfig(state_dtype=state_dtype))


#: int8 moments: arctic (the dry run's int8 cell) and one config of each
#: other leaf layout (hybrid 1-D leaves, xLSTM 4-D leaves, QKV biases)
INT8_CONFIGS = [("arctic-480b", None), ("zamba2-2.7b", None),
                ("xlstm-350m", None), ("qwen1.5-4b", None)]


@pytest.mark.parametrize("arch,shape,state_dtype",
                         [c + ("float32",) for c in CONFIGS]
                         + [c + ("int8",) for c in INT8_CONFIGS])
def test_opt_state_placements_match_reference(meshes, arch, shape,
                                              state_dtype):
    mesh, standin = meshes
    cfg = get_config(arch, shape)
    state = port_state(arch, shape, state_dtype)
    shard = sharding.opt_state_shardings(cfg, mesh, state)
    port = {}
    for name, moments in state.items():
        for key, mom in moments.items():
            fields = {"": mom} if isinstance(mom, torch.Tensor) else \
                {"codes": mom.codes, "scale": mom.scale}
            for field, t in fields.items():
                path = "/".join(filter(None, (reference_path(name), key,
                                              field)))
                port.setdefault(path, []).append(
                    (shard[name][key][field], t.shape, t.dtype))
    params = ref_params(arch, shape)
    opt = jax.eval_shape(lambda: ref_init_opt_state(
        params, RefAdamWConfig(state_dtype=state_dtype)))
    rcfg = ref_config(arch, shape)
    specs = jax.tree_util.tree_leaves(
        ref_sharding.opt_state_shardings(rcfg, standin, opt))
    by_path = dict(zip(ref_leaves(opt), (s.spec for s in specs)))
    check_leaves(mesh, standin, port, ref_leaves(opt),
                 lambda path, leaf: by_path[path])


@pytest.fixture(autouse=True)
def _spec_only_named_sharding(monkeypatch):
    """The reference's ``*_shardings`` wrap each spec in a
    ``NamedSharding``, which needs a real mesh; here it keeps the spec."""
    monkeypatch.setattr(ref_sharding, "NamedSharding",
                        lambda mesh, spec: types.SimpleNamespace(spec=spec))


CELLS = [(a, s.name) for a in ARCH_IDS for s in ALL_SHAPES
         if cell_status(a, s.name) == "run"]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_batch_and_cache_placements_match_reference(meshes, arch, shape):
    """The inputs of every runnable cell, and the decode cells' caches."""
    from repro_torch.configs.base import shape_by_name

    mesh, standin = meshes
    cfg, rcfg = get_config(arch, shape), ref_config(arch, shape)
    sh = shape_by_name(shape)
    batch = input_specs(cfg, sh)
    ref_batch = {k: v for k, v in ref_steps.input_specs(rcfg, sh).items()
                 if k != "pos"}
    shard = sharding.batch_shardings(cfg, mesh, batch)
    ref_specs = {k: s.spec for k, s in ref_sharding.batch_shardings(
        rcfg, standin, ref_batch).items()}
    check_leaves(mesh, standin,
                 {k: [(shard[k], v.shape, v.dtype)] for k, v in batch.items()},
                 ref_batch, lambda path, leaf: ref_specs[path])
    if sh.kind != "decode":
        return
    cache = abstract_cache(cfg, sh)
    ref_cache = ref_steps.abstract_cache(rcfg, sh)
    shard = sharding.cache_shardings(cfg, mesh, cache)
    specs = jax.tree_util.tree_leaves(
        ref_sharding.cache_shardings(rcfg, standin, ref_cache))
    by_path = dict(zip(ref_leaves(ref_cache), (s.spec for s in specs)))
    check_leaves(mesh, standin,
                 {k: [(shard[k], v.shape, v.dtype)] for k, v in cache.items()},
                 ref_leaves(ref_cache), lambda path, leaf: by_path[path])


def test_indivisible_dims_replicate(meshes):
    """The divisibility fallback: hubert's 504-way head and a width that
    16 does not divide stay whole on those axes."""
    mesh, standin = meshes
    cfg = get_config("hubert-xlarge")
    spec = sharding.param_spec(cfg, mesh, "lm_head", (1280, 504))
    assert spec == ref_sharding.param_spec(
        ref_config("hubert-xlarge"), standin, "lm_head",
        types.SimpleNamespace(shape=(1280, 504)))
    assert spec[1] is None
    from torch.distributed.tensor import Replicate
    assert sharding.placements(mesh, sharding.P(None, None)) == \
        sharding.replicated(mesh) == (Replicate(),) * mesh.ndim
