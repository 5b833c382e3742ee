"""The port's sharding specs (``repro_torch.distributed.sharding``, the
optimizers' ``state_specs``, ``step.state_spec_tree``, ``cache_spec``)
against the JAX package's, on the CPU, for all ten archs.

A spec is data on the port's side: the JAX package's ``P(*dims)`` is
``tuple(dims)`` there, and a mesh is an axis-name -> size mapping.  The
reference's specs are built on its single-device mesh and on a
production-mesh stand-in (pod 2, data 16, model 16, no devices, as in
``tests/test_sharding_specs.py``); its leaf shapes come from
``jax.eval_shape``, the port's from ``meta`` tensors.  Nothing is
allocated on either side.  Specs compare exactly, up to one equivalence
that ``PartitionSpec`` applies itself: an entry that is a tuple of one
axis name is that name (``P(("data",))`` holds ``"data"``); per-device bytes
(``spec_bytes`` against the reference's ``dryrun._spec_bytes``) are
integers and compare exactly too.
"""

import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from _repro_reference import reference
from repro_torch.configs import registry
from repro_torch.distributed import sharding
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import PRODUCTION_MESHES
from repro_torch.models import encdec, lm
from repro_torch.train import optim, schedules
from repro_torch.train import step as S

PROD = {"pod": 2, "data": 16, "model": 16}
SINGLE = {"data": 1, "model": 1}


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


class _FakeMesh:
    """Production-mesh stand-in for the reference's spec construction."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.devices = np.empty(math.prod(shape.values()))


def _entry(e):
    return e[0] if isinstance(e, tuple) and len(e) == 1 else e


def tuples(tree):
    """A reference spec tree with every ``PartitionSpec`` as a tuple."""
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


def norm(tree):
    """A port spec tree with each one-name tuple entry as that name, as a
    ``PartitionSpec`` holds it."""
    if isinstance(tree, dict):
        return {k: norm(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [norm(v) for v in tree]
    return tuple(_entry(e) for e in tree)


def ctx_pair(ref, mesh, batch_size=None):
    """(reference ShardCtx, port ShardCtx) for one mesh mapping."""
    if mesh == SINGLE:
        rmesh = ref.layers.single_device_mesh()
    else:
        rmesh = _FakeMesh(mesh)
    return (ref.sharding.make_ctx(rmesh, batch_size=batch_size),
            sharding.make_ctx(mesh, batch_size=batch_size))


def production_ctx_pair(ref):
    """The reference test's production context (its dp set by hand)."""
    return (ref.layers.ShardCtx(mesh=_FakeMesh(PROD), dp=("pod", "data"),
                                tp="model"),
            sharding.ShardCtx(mesh=PROD, dp=("pod", "data"), tp="model"))


def configs(ref, arch, smoke):
    entry_r, entry_p = ref.registry.get(arch), registry.get(arch)
    if smoke:
        return entry_r, entry_r.smoke(), entry_p, entry_p.smoke()
    return entry_r, entry_r.config, entry_p, entry_p.config


def abstract_pair(ref, arch, smoke):
    """(reference eval_shape params, port param_tree on meta, the port's
    model, both configs)."""
    entry_r, cfg_r, entry_p, cfg_p = configs(ref, arch, smoke)
    init = ref.encdec.init_params if entry_r.is_encdec \
        else ref.lm.init_params
    aparams = jax.eval_shape(lambda: init(cfg_r, jax.random.PRNGKey(0)))
    model = (encdec if entry_p.is_encdec else lm).abstract_params(cfg_p)
    return aparams, S.param_tree(model), model, cfg_r, cfg_p


def assert_structure(specs, tree):
    """``specs`` has ``tree``'s dicts and lists, a spec tuple at each
    leaf, no longer than the leaf's rank."""
    if isinstance(tree, dict):
        assert isinstance(specs, dict) and set(specs) == set(tree), \
            (sorted(specs), sorted(tree))
        for k in tree:
            assert_structure(specs[k], tree[k])
    elif isinstance(tree, list):
        assert isinstance(specs, list) and len(specs) == len(tree)
        for s, t in zip(specs, tree):
            assert_structure(s, t)
    else:       # a tensor, or a stacked layout leaf: the repeats' tensors
        rank = tree[0].dim() + 1 if isinstance(tree, tuple) else tree.dim()
        assert isinstance(specs, tuple) and len(specs) <= rank, (specs, tree)


def opt_pair(ref, name):
    lr = schedules.cosine(3e-4, 100, 10_000)
    lr_r = ref.schedules.cosine(3e-4, 100, 10_000)
    return getattr(ref.optim, name)(lr_r), getattr(optim, name)(lr)


# ------------------------------------------------------------- contexts

@pytest.mark.parametrize("mesh", [SINGLE, PRODUCTION_MESHES["pod"],
                                  PRODUCTION_MESHES["multipod"]],
                         ids=["single", "pod", "multipod"])
def test_make_ctx_matches_reference(ref, mesh):
    for batch in (None, 1, 8, 16, 32, 256):
        r, p = ctx_pair(ref, mesh, batch)
        assert (p.dp, p.tp, p.batch_sharded) == (r.dp, r.tp, r.batch_sharded)
        assert (p.tp_size, p.dp_size, p.dp_spec) \
            == (r.tp_size, r.dp_size, r.dp_spec)
        assert [p.can_shard(n) for n in (1, 8, 14, 16, 32)] \
            == [r.can_shard(n) for n in (1, 8, 14, 16, 32)]
    assert sharding.make_ctx(None) == sharding.ShardCtx()
    assert sharding.ShardCtx().tp_size == sharding.ShardCtx().dp_size == 1


# --------------------------------------------------------------- params

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_param_specs_match_reference_on_smoke_configs(ref, arch):
    _, _, model, cfg_r, cfg_p = abstract_pair(ref, arch, smoke=True)
    r, p = ctx_pair(ref, SINGLE)
    specs = sharding.param_specs(cfg_p, p)
    assert specs == tuples(ref.sharding.param_specs(cfg_r, r))
    lib = encdec if registry.get(arch).is_encdec else lm
    assert_structure(specs, lib.param_layout(model))


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_full_config_specs_match_reference_and_divide(ref, arch):
    """On the production mesh every sharded dim of the full config divides
    evenly, as the reference's own test requires."""
    _, params, _, cfg_r, cfg_p = abstract_pair(ref, arch, smoke=False)
    r, p = production_ctx_pair(ref)
    specs = sharding.param_specs(cfg_p, p)
    assert specs == tuples(ref.sharding.param_specs(cfg_r, r))
    assert_structure(specs, params)

    def divides(x, s):
        for i, entry in enumerate(s):
            n = math.prod(PROD[a] for a in sharding._axes(entry)
                          if a is not None)
            assert x.shape[i] % n == 0, (arch, tuple(x.shape), s, i)
    sharding.zip_specs(divides, params, specs)


# ------------------------------------------------- gradients and state

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_state_specs_and_bytes_match_reference(ref, arch):
    """grad_specs, zero1_specs, both optimizers' state_specs and
    state_spec_tree on the full config at the production mesh, their
    structure against the port's init_state, and the per-device bytes of
    parameters and state against the reference's ``_spec_bytes``."""
    aparams, params, model, cfg_r, cfg_p = abstract_pair(ref, arch,
                                                         smoke=False)
    r, p = production_ctx_pair(ref)
    pspecs_r = ref.sharding.param_specs(cfg_r, r)
    pspecs = sharding.param_specs(cfg_p, p)
    assert sharding.grad_specs(params, pspecs, p) \
        == tuples(ref.sharding.grad_specs(aparams, pspecs_r, r))
    assert sharding.zero1_specs(params, pspecs, p) \
        == tuples(ref.sharding.zero1_specs(aparams, pspecs_r, r))
    mesh = _FakeMesh(PROD)
    assert sharding.spec_bytes(params, pspecs, PROD) \
        == ref.dryrun._spec_bytes(aparams, pspecs_r, mesh)
    for name in ("adamw", "adafactor"):
        opt_r, opt = opt_pair(ref, name)
        got = S.state_spec_tree(cfg_p, p, opt, params)
        assert got == tuples(ref.step.state_spec_tree(cfg_r, r, opt_r,
                                                      aparams))
        state = S.init_state(model, opt)
        assert_structure(got, state)
        astate = jax.eval_shape(opt_r.init, aparams)
        assert sharding.spec_bytes(state["opt"], got["opt"], PROD) \
            == ref.dryrun._spec_bytes(astate, opt_r.state_specs(
                aparams, pspecs_r, r), mesh)


def test_state_specs_without_a_mesh_are_the_parameters(ref):
    _, params, model, cfg_r, cfg_p = abstract_pair(ref, "granite-3-2b",
                                                   smoke=True)
    ctx = sharding.make_ctx(None)
    pspecs = sharding.param_specs(cfg_p, ctx)
    assert sharding.zero1_specs(params, pspecs, ctx) is pspecs
    assert sharding.grad_specs(params, pspecs, ctx) is pspecs
    r, p = ctx_pair(ref, SINGLE)
    z = sharding.zero1_specs(params, sharding.param_specs(cfg_p, p), p)
    # embed (V, d) is (model, None): ZeRO adds data on dim 1
    assert z["embed"] == ("model", "data")
    assert z == tuples(ref.sharding.zero1_specs(
        jax.eval_shape(lambda: ref.lm.init_params(
            cfg_r, jax.random.PRNGKey(0))),
        ref.sharding.param_specs(cfg_r, r), r))


# ---------------------------------------------------- batches and caches

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_batch_and_cache_specs_match_reference(ref, arch):
    """batch_specs of every shape's inputs, and cache_spec against the
    reference's less its stacked repeat axis, and the cache's per-device
    bytes equal the reference's (a window block holds ``min(window, S)``
    slots in both)."""
    entry_r, cfg_r, entry_p, cfg_p = configs(ref, arch, smoke=False)
    for mesh in PRODUCTION_MESHES.values():
        for name, shape_p in entry_p.shapes.items():
            shape_r = entry_r.shapes[name]
            r, p = ctx_pair(ref, mesh, shape_p.global_batch)
            got = sharding.batch_specs(entry_p.input_specs(shape_p), p)
            assert norm(got) == tuples(ref.sharding.batch_specs(
                entry_r.input_specs(shape_r), r))
            if shape_p.kind != "decode":
                continue
            B, S_ = shape_p.global_batch, shape_p.seq_len
            lib, lib_r = ((encdec, ref.encdec) if entry_p.is_encdec
                          else (lm, ref.lm))
            spec = lib.cache_spec(cfg_p, p)
            spec_r = tuples(lib_r.cache_spec(cfg_r, r))
            if entry_p.is_encdec:
                want = [{k: v[1:] for k, v in spec_r["dec"].items()}
                        for _ in range(cfg_p.n_dec_layers)]
            else:
                want = [spec_r[f"pre{i}"] for i in range(len(cfg_p.prefix))]
                want += [{k: v[1:] for k, v in
                          spec_r["pattern"][f"blk{j}"].items()}
                         for _ in range(cfg_p.n_repeats)
                         for j in range(len(cfg_p.pattern))]
                want += [spec_r[f"suf{i}"] for i in range(len(cfg_p.suffix))]
            assert norm(spec) == want
            cache = lib.abstract_cache(cfg_p, B, S_)
            assert_structure(spec, cache)
            init_c = lib_r.init_cache
            acache = jax.eval_shape(lambda: init_c(cfg_r, B, S_))
            assert sharding.spec_bytes(cache, spec, mesh) \
                == ref.dryrun._spec_bytes(acache, lib_r.cache_spec(cfg_r, r),
                                          _FakeMesh(mesh))


# ------------------------------------------------------------- dry-run

@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_dryrun_records_production_mesh_state_bytes(ref, arch):
    """The dry-run's train cell carries the reference's per-device state
    bytes on both production meshes: parameters plus the optimizer state
    of ``for_arch``, specs from a context at the cell's global batch."""
    cell = dryrun.build_cell(arch, "train_4k")
    entry_r, cfg_r, _, _ = configs(ref, arch, smoke=False)
    shape = entry_r.shapes["train_4k"]
    init = ref.encdec.init_params if entry_r.is_encdec \
        else ref.lm.init_params
    aparams = jax.eval_shape(lambda: init(cfg_r, jax.random.PRNGKey(0)))
    opt = ref.optim.for_arch(cfg_r.param_count(),
                             ref.schedules.cosine(3e-4, 100, 10_000))
    astate = jax.eval_shape(opt.init, aparams)
    want = {}
    for name, mesh in PRODUCTION_MESHES.items():
        fake = _FakeMesh(mesh)
        ctx = ref.sharding.make_ctx(fake, batch_size=shape.global_batch)
        pspecs = ref.sharding.param_specs(cfg_r, ctx)
        want[name] = (ref.dryrun._spec_bytes(aparams, pspecs, fake)
                      + ref.dryrun._spec_bytes(
                          astate, opt.state_specs(aparams, pspecs, ctx),
                          fake))
    assert cell.meta["mesh_state_bytes_per_device"] == want
    assert cell.meta["optimizer"] == opt.name
    assert all(v < cell.meta["state_bytes_per_device"] for v in want.values())


def test_dryrun_record_mesh_bytes_for_prefill_and_decode():
    """Prefill counts the parameters alone; decode adds the cache, sharded
    by the port's own ``cache_spec``."""
    for shape in ("prefill_32k", "decode_32k"):
        cell = dryrun.build_cell("granite-3-2b", shape, smoke=True)
        model = lm.abstract_params(cell.cfg)
        params = S.param_tree(model)
        for name, mesh in PRODUCTION_MESHES.items():
            ctx = sharding.make_ctx(mesh, batch_size=cell.shape.global_batch)
            want = sharding.spec_bytes(
                params, sharding.param_specs(cell.cfg, ctx), mesh)
            if shape.startswith("decode"):
                cache = lm.abstract_cache(cell.cfg, cell.shape.global_batch,
                                          cell.shape.seq_len)
                want += sharding.spec_bytes(
                    cache, lm.cache_spec(cell.cfg, ctx), mesh)
            assert cell.meta["mesh_state_bytes_per_device"][name] == want
    record = dryrun.run_cell("granite-3-2b", "decode_32k", smoke=True,
                             quiet=True)
    assert set(record["mesh_state_bytes_per_device"]) == {"pod", "multipod"}


def test_spec_bytes_rounds_down_per_leaf():
    t = {"a": torch.empty((3, 5), dtype=torch.bfloat16, device="meta"),
         "b": [torch.empty((16,), dtype=torch.float32, device="meta")]}
    specs = {"a": ("model", None), "b": [(("pod", "data"),)]}
    assert sharding.spec_bytes(t, specs, PROD) == 30 // 16 + 64 // 32
