"""The port's trained sparsity profiles and sigma-delta calibration against
the JAX package's, on the CPU.

Profiles are host numpy in both packages and ``apply`` makes the same
numpy draws in the same order, so programmed weights and message gates
are bit-identical; the npz layout is shared, so a profile saved by either
package loads in the other.  Calibration is float64 numpy in both and
compares exactly.  Profiled pricing agrees to rtol 1e-9 (the float64
pricing contract of the earlier slices).
"""

import pathlib

import numpy as np
import pytest
import torch

from _repro_reference import reference
from _torch_workloads import conv_pair, fc_pair
from repro_torch.core.partitioner import SimEvaluator
from repro_torch.neuromorphic import (loihi2_like, minimal_partition,
                                      ordered_mapping, precompute_pricing,
                                      random_mapping, simulate,
                                      simulate_population, strided_mapping)
from repro_torch.neuromorphic.network import _exact_density_mask
from repro_torch.sparsity import (SparsityProfile, calibrate_thresholds,
                                  delta_sparsity, sigma_delta_densities,
                                  sigma_delta_messages)

RTOL = 1e-9
GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _profile_kw(net_r, variant: str, seed: int) -> dict:
    """Constructor arguments of a profile for ``net_r``'s layers: exact
    masks of the layers' shapes (``masks``), densities only
    (``densities``), or a shorter profile with thresholds whose masks
    match no layer (``short``)."""
    rng = np.random.default_rng(100 + seed)
    n = len(net_r.layers)
    names = [l.name for l in net_r.layers]
    if variant == "masks":
        masks = [_exact_density_mask(np.shape(l.weights), 0.5, rng)
                 for l in net_r.layers]
        return dict(layer_names=names, act_density=rng.random(n),
                    weight_density=np.full(n, 0.5), weight_masks=masks)
    if variant == "densities":
        return dict(layer_names=names, act_density=rng.random(n),
                    weight_density=rng.uniform(0.3, 1.0, n))
    return dict(layer_names=names[:2], act_density=rng.random(2),
                weight_density=np.array([0.7, 1.0]),
                weight_masks=[np.ones((3, 3), np.float32)],
                thresholds=(0.05, 0.2))


def _assert_nets_equal(net_r, net_p):
    assert len(net_r.layers) == len(net_p.layers)
    for a, b in zip(net_r.layers, net_p.layers):
        assert np.array_equal(np.asarray(a.weights), b.weights.numpy())
        assert b.weights.dtype == torch.float32
        if a.msg_gate is None:
            assert b.msg_gate is None
        else:
            assert np.array_equal(np.asarray(a.msg_gate), b.msg_gate.numpy())
        assert a.threshold == b.threshold


# ------------------------------------------------------------ builders

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_activations_matches_reference(ref, seed):
    rng = np.random.default_rng(seed)
    acts = [rng.normal(size=(6, 20)), rng.normal(size=(3, 4, 5))]
    weights = [rng.normal(size=(20, 8)) * (rng.random((20, 8)) < 0.4),
               rng.normal(size=(8, 5))]
    masks = [(w != 0).astype(np.float32) for w in weights]
    for kw in (dict(), dict(weights=weights), dict(masks=masks),
               dict(masks=masks, thresh=0.3, thresholds=(0.1, 0.2),
                    input_density=0.4, meta={"recipe": "t"})):
        r = ref.profile.SparsityProfile.from_activations(("a", "b"), acts,
                                                         **kw)
        # the port takes tensors too
        p = SparsityProfile.from_activations(
            ("a", "b"), [torch.from_numpy(a) for a in acts],
            **{k: ([torch.from_numpy(np.asarray(x)) for x in v]
                   if k in ("weights", "masks") else v)
               for k, v in kw.items()})
        assert np.array_equal(r.act_density, p.act_density)
        assert np.array_equal(r.weight_density, p.weight_density)
        assert (r.thresholds, r.input_density, r.meta) \
            == (p.thresholds, p.input_density, p.meta)
        assert (r.weight_masks is None) == (p.weight_masks is None)
        for a, b in zip(r.weight_masks or (), p.weight_masks or ()):
            assert np.array_equal(a, b) and b.dtype == np.float32


@pytest.mark.parametrize("src", [1, 3, 4])
def test_densities_for_matches_reference(ref, src):
    dens = np.linspace(0.2, 0.9, src) ** 2
    kw = dict(layer_names=[f"l{i}" for i in range(src)], act_density=dens,
              weight_density=np.ones(src))
    r = ref.profile.SparsityProfile(**kw)
    p = SparsityProfile(**kw)
    for n in (1, 2, src, 5, 9):
        got = p.densities_for(n)
        assert np.array_equal(got, r.densities_for(n))
        assert got.shape == (n,)
    assert p.densities_for(src) is not p.act_density      # a copy


def test_profile_validates_shapes():
    with pytest.raises(ValueError, match="to match layer_names"):
        SparsityProfile(layer_names=("a", "b"), act_density=[0.1],
                        weight_density=[1.0, 1.0])


@pytest.mark.parametrize("variant", ["masks", "densities", "short"])
@pytest.mark.parametrize("kind", ["fc", "conv"])
@pytest.mark.parametrize("seed", [0, 3])
def test_apply_matches_reference(ref, kind, variant, seed):
    net_r, net_p, _ = (fc_pair if kind == "fc" else conv_pair)(ref)
    kw = _profile_kw(net_r, variant, seed)
    if variant == "short":
        # thresholds apply to delta-sending layers only
        for net in (net_r, net_p):
            net.layers[0].sends_deltas = True
    before = [l.weights.clone() for l in net_p.layers]
    got = SparsityProfile(**kw).apply(net_p, seed=seed)
    want = ref.profile.SparsityProfile(**kw).apply(net_r, seed=seed)
    _assert_nets_equal(want, got)
    for b, l in zip(before, net_p.layers):          # input untouched
        assert torch.equal(b, l.weights)


# ------------------------------------------------------------- persist

def _full_profile():
    rng = np.random.default_rng(5)
    return dict(layer_names=("fc0", "fc1"), act_density=[0.3, 0.6],
                weight_density=[0.5, 0.9],
                weight_masks=[_exact_density_mask((6, 4), 0.5, rng),
                              _exact_density_mask((4, 3), 0.9, rng)],
                thresholds=(0.05, 0.1), input_density=0.25,
                meta={"recipe": "sd", "step": 12})


def _assert_profiles_equal(a, b):
    assert a.layer_names == b.layer_names
    assert np.array_equal(a.act_density, b.act_density)
    assert np.array_equal(a.weight_density, b.weight_density)
    assert (a.thresholds, a.input_density, a.meta) \
        == (b.thresholds, b.input_density, b.meta)
    assert (a.weight_masks is None) == (b.weight_masks is None)
    for x, y in zip(a.weight_masks or (), b.weight_masks or ()):
        assert np.array_equal(x, y)


@pytest.mark.parametrize("writer", ["port", "reference"])
@pytest.mark.parametrize("full", [True, False])
def test_save_load_across_packages(ref, tmp_path, writer, full):
    kw = _full_profile() if full else dict(
        layer_names=("a",), act_density=[0.4], weight_density=[1.0])
    port, refp = SparsityProfile(**kw), ref.profile.SparsityProfile(**kw)
    path = tmp_path / "sub" / "profile.npz"
    (port if writer == "port" else refp).save(path)
    assert sorted(p.name for p in path.parent.iterdir()) == ["profile.npz"]
    with np.load(path) as data:
        keys = set(data.files)
    assert {"act_density", "weight_density", "header"} <= keys
    assert ("thresholds" in keys) == full
    assert {k for k in keys if k.startswith("mask_")} \
        == ({"mask_0", "mask_1"} if full else set())
    _assert_profiles_equal(SparsityProfile.load(path),
                           ref.profile.SparsityProfile.load(path))
    _assert_profiles_equal(SparsityProfile.load(path), port)


def test_committed_trained_profile_loads_as_in_reference(ref):
    path = GOLDEN / "trained_profile.npz"
    p = SparsityProfile.load(path)
    _assert_profiles_equal(p, ref.profile.SparsityProfile.load(path))
    assert p.layer_names == ("fc0", "fc1", "fc2")
    assert [m.shape for m in p.weight_masks] == [(32, 48), (48, 48),
                                                 (48, 24)]


# --------------------------------------------------------- calibration

@pytest.mark.parametrize("seed", [0, 1])
def test_calibration_matches_reference(ref, seed):
    rng = np.random.default_rng(seed)
    deltas = [rng.normal(size=(16, 30)), rng.laplace(size=(8, 50)) * 0.1]
    acts = [np.abs(rng.normal(size=(12, 20))),
            np.maximum(rng.normal(size=(9, 7)), 0.0)]
    sd = ref.sd_sparsity
    for tgt in (0.5, [0.3, 0.9]):
        got = calibrate_thresholds(deltas, tgt)
        assert got == sd.calibrate_thresholds(deltas, tgt)
        assert got == calibrate_thresholds(deltas, tgt, iters=40)
    assert calibrate_thresholds(deltas, 0.7, iters=5) \
        == sd.calibrate_thresholds(deltas, 0.7, iters=5)
    for theta in (0.0, 0.3, 1.1):
        assert delta_sparsity(deltas[0], theta) \
            == sd.delta_sparsity(deltas[0], theta)
    thetas = [0.2, 0.05]
    assert sigma_delta_densities(acts, thetas) \
        == sd.sigma_delta_densities(acts, thetas)
    q, s = sigma_delta_messages(acts[0][1], acts[0][0], 0.3)
    qr, sr = sd.sigma_delta_messages(acts[0][1], acts[0][0], 0.3)
    assert np.array_equal(q, qr) and np.array_equal(s, sr)


# ------------------------------------------------------ profiled pricing

def _assert_reports_close(p, r):
    for f in ("times", "energies", "per_core_synops", "per_core_acts",
              "per_core_msgs_out"):
        np.testing.assert_allclose(getattr(p, f).numpy(),
                                   np.asarray(getattr(r, f)), rtol=RTOL,
                                   atol=RTOL, err_msg=f)
    for f in ("time_per_step", "energy_per_step", "max_synops", "max_acts",
              "max_link_load"):
        np.testing.assert_allclose(getattr(p, f), getattr(r, f), rtol=RTOL,
                                   err_msg=f)
    assert p.bottleneck_stage == r.bottleneck_stage
    assert p.n_cores_active == r.n_cores_active
    np.testing.assert_allclose(p.metrics.act_density, r.metrics.act_density,
                               rtol=RTOL)
    np.testing.assert_allclose(p.metrics.weight_density,
                               r.metrics.weight_density, rtol=RTOL)


@pytest.mark.parametrize("kind", ["fc", "conv"])
def test_profiled_pricing_matches_reference(ref, kind):
    net_r, net_p, xs = (fc_pair if kind == "fc" else conv_pair)(ref)
    kw = _profile_kw(net_r, "densities", 1)
    prof_p, prof_r = SparsityProfile(**kw), ref.profile.SparsityProfile(**kw)
    chip_r, chip_p = ref.platform.loihi2_like(), loihi2_like()
    rs = ref.timestep.simulate(net_r, xs, chip_r, sparsity_profile=prof_r)
    ps = simulate(net_p, xs, chip_p, sparsity_profile=prof_p)
    _assert_reports_close(ps, rs)
    # the profile really programmed the network
    plain = simulate(net_p, xs, chip_p)
    assert plain.metrics.weight_density != ps.metrics.weight_density

    cache_r = ref.timestep.precompute_pricing(net_r, xs, chip_r,
                                              sparsity_profile=prof_r)
    cache_p = precompute_pricing(net_p, xs, chip_p, sparsity_profile=prof_p)
    for a, b in zip(cache_r.layers, cache_p.layers):
        np.testing.assert_allclose(b.csum_macs.numpy(), a.csum_macs,
                                   rtol=RTOL)
        np.testing.assert_allclose(b.csum_msgs.numpy(), a.csum_msgs,
                                   rtol=RTOL)

    p0 = minimal_partition(net_p, chip_p)
    rng = np.random.default_rng(4)
    parts = [p0, p0.split(0), p0.split(len(p0.cores) - 1)]
    cands = [(pt, mk(pt, chip_p)) for pt in parts
             for mk in (ordered_mapping, strided_mapping)]
    cands += [(pt, random_mapping(pt, chip_p, rng)) for pt in parts]
    cands_r = [(ref.partition.Partition(pt.cores),
                ref.noc.Mapping(m.phys, name=m.name)) for pt, m in cands]
    want = ref.timestep.simulate_population(net_r, xs, chip_r, cands_r,
                                            sparsity_profile=prof_r)
    for backend in ("numpy", "device"):
        got = simulate_population(net_p, xs, chip_p, cands, backend=backend,
                                  sparsity_profile=prof_p)
        for p, r in zip(got, want):
            _assert_reports_close(p, r)
    ev = SimEvaluator(net_p, xs, chip_p, sparsity_profile=prof_p)
    assert ev.sparsity_profile is prof_p
    _assert_reports_close(ev(*cands[0]), want[0])


def test_profile_with_bound_cache_raises(ref):
    _, net, xs = fc_pair(ref)
    chip = loihi2_like()
    prof = SparsityProfile(("a",), [0.5], [0.5])
    run = net.run_batch(torch.from_numpy(xs))
    cache = precompute_pricing(net, xs, chip, precomputed=run)
    with pytest.raises(ValueError, match="un-profiled"):
        simulate(net, xs, chip, precomputed=run, sparsity_profile=prof)
    with pytest.raises(ValueError, match="un-profiled"):
        precompute_pricing(net, xs, chip, precomputed=run,
                           sparsity_profile=prof)
    p0 = minimal_partition(net, chip)
    for kw in (dict(cache=cache), dict(precomputed=run)):
        with pytest.raises(ValueError, match="un-profiled"):
            simulate_population(net, xs, chip,
                                [(p0, ordered_mapping(p0, chip))],
                                sparsity_profile=prof, **kw)
    with pytest.raises(ValueError, match="un-profiled"):
        SimEvaluator(net, xs, chip, cache=cache, sparsity_profile=prof)
