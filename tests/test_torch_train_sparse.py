"""The port's sparsity-aware training stack against the JAX package's, on
the CPU: pruning, the regularizers, the synthetic data, the float32
``normal`` behind the weight init, and ``SparseTrainer``.

Tolerances, and why:

* masks, data batches, kept counts, activation densities and the
  profile's masks: exact (the same float32 arithmetic, or numpy on both
  sides);
* regularizer values rtol 1e-6 of their float64 value and ``REG_RTOL``
  of the JAX package's: XLA sums float32 sequentially on the CPU, 1.3e-6
  off the float64 value here, where torch's pairwise sum stays within
  1.6e-7 (measured: 1.4e-6 apart at most); gradients rtol 1e-5;
* ``normal`` and ``mlp_init``: at most 2 ulp, and only in the far tails
  (XLA's ``log`` of 1 - u*u, see ``repro_torch.core.prng.normal``);
* one update from the same state: loss rtol 1e-6, gradients rtol 1e-5 with
  atol 1e-7, moments and parameters atol ``STEP_ATOL`` (measured: 3.7e-8
  at most): the Adam-like step divides the first moment by the root of
  the second, so a gradient that roundoff moves near zero can move a
  parameter by a sizeable share of ``lr``;
* floorline weights rtol 1e-9 (float64 pricing of identical weights);
* thresholds rtol 1e-6 (bisection on deltas of float32 activations);
* a 20-step run from the same initial weights: losses within
  ``RUN_RTOL`` (measured: 1.2e-7 at most);
* kill and resume in the port: bit for bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _repro_reference import reference
from repro_torch import sparsity as S
from repro_torch import train as T
from repro_torch.core import prng
from repro_torch.neuromorphic import loihi2_like
from repro_torch.train import data as D
from repro_torch.train.sparse import params_from_numpy
from repro_torch.tree import tree_leaves, tree_map

SIZES = (32, 48, 32, 10)            # images task: 32 = 2*4^2
REG_RTOL = 5e-6                     # regularizer values vs the JAX package
STEP_ATOL = 1e-6                    # moments / params after one update
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
RUN_RTOL = 1e-5                     # 20-step losses, same initial weights


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def _cfg(mod, **kw):
    base = dict(sizes=SIZES, steps=12, batch=32, seed=0)
    base.update(kw)
    return mod.SparseTrainConfig(**base)


def _carry(rt, *, layer_weights=None, **kw) -> "T.SparseTrainer":
    """A CPU port trainer holding the reference trainer ``rt``'s weights,
    moments, masks, step and losses."""
    pt = T.SparseTrainer(_cfg(T, **kw), layer_weights=layer_weights,
                         device="cpu")
    pt.params = params_from_numpy(rt.params, "cpu")
    pt.opt_m = params_from_numpy(rt.opt_m, "cpu")
    pt.opt_v = params_from_numpy(rt.opt_v, "cpu")
    pt.masks = params_from_numpy(rt.masks, "cpu")
    pt.step, pt.losses = rt.step, list(rt.losses)
    return pt


# ------------------------------------------------------------------ exports

def test_exports_match_reference(ref):
    """The reference's names; ``repro_torch.train`` also exports the LM
    trainer's, which the reference exports from its submodules."""
    import importlib
    assert S.__all__ == ref.sparsity.__all__
    assert set(ref.train.__all__) <= set(T.__all__)
    subs = [importlib.import_module(f"repro.train.{m}")
            for m in ("loop", "optim", "step")]
    for name in set(T.__all__) - set(ref.train.__all__):
        assert any(hasattr(m, name) for m in subs), name
    for name in S.__all__:
        assert getattr(S, name) is not None
    for name in T.__all__:
        assert getattr(T, name) is not None


# ------------------------------------------------------------------ pruning

def _prune_cases():
    rng = np.random.default_rng(0)
    ties = rng.integers(-3, 4, size=(12, 16)).astype(np.float32)
    return {
        "random": ({"b": rng.standard_normal((16, 24)).astype(np.float32),
                    "a": [rng.standard_normal((8, 9)).astype(np.float32),
                          rng.standard_normal((4, 4)).astype(np.float32)]},
                   0.5, 64),
        # many equal magnitudes: ties break toward the lowest flat index
        "ties": ([ties, np.abs(ties)], 0.37, 64),
        # a vector and a tensor below min_size are never pruned
        "min_size_ndim": ([rng.standard_normal(200).astype(np.float32),
                           rng.standard_normal((7, 9)).astype(np.float32),
                           rng.standard_normal((8, 8)).astype(np.float32)],
                          0.6, 64),
        # n = 85 at s = 0.3: float32 keeps 60, float64 would keep 59
        "float32_k": ((rng.standard_normal((5, 17)).astype(np.float32),
                       rng.standard_normal((5, 31)).astype(np.float32)),
                      0.3, 1),
        "all_and_none": ([rng.standard_normal((6, 6)).astype(np.float32)] * 2,
                         0.0, 1),
        "full": ([rng.standard_normal((6, 6)).astype(np.float32)], 1.0, 1),
    }


@pytest.mark.parametrize("case", sorted(_prune_cases()))
def test_prune_masks_bit_identical(ref, case):
    tree, s, min_size = _prune_cases()[case]
    to_t = lambda t: tree_map(torch.from_numpy, t)
    got = S.magnitude_prune_masks(to_t(tree), s, min_size=min_size)
    want = ref.pruning.magnitude_prune_masks(
        jax.tree.map(jnp.asarray, tree), s, min_size=min_size)
    g_leaves = tree_leaves(got)
    w_leaves = jax.tree.leaves(want)
    assert len(g_leaves) == len(w_leaves)
    for g, w, p in zip(g_leaves, w_leaves, jax.tree.leaves(tree)):
        assert g.dtype == torch.float32 and g.shape == p.shape
        assert np.array_equal(_np(g), np.asarray(w))
    assert type(got) is type(tree)
    masked = S.apply_masks(to_t(tree), got)
    for g, w in zip(tree_leaves(masked), jax.tree.leaves(
            ref.pruning.apply_masks(jax.tree.map(jnp.asarray, tree),
                                    want))):
        assert np.array_equal(_np(g), np.asarray(w))
    assert S.weight_sparsity(None, got) == \
        ref.pruning.weight_sparsity(None, want)
    assert S.weight_sparsity(masked) == ref.pruning.weight_sparsity(
        jax.tree.leaves(want))


def test_kept_count_is_the_float32_rounding():
    """``round(n * (1 - s))`` in float32 (half to even) for a grid that
    holds cases where float64 rounds the other way."""
    n = jnp.arange(64, 4000, 7)
    for s in (0.05, 0.3, 0.35, 0.5, 0.55, 0.9, 0.999):
        k = jnp.clip(jnp.round(n * (1.0 - jnp.asarray(s, jnp.float32))),
                     0, n).astype(jnp.int32)
        got = [S.pruning._kept(int(m), s) for m in np.asarray(n)]
        assert got == np.asarray(k).tolist()
    assert S.pruning._kept(85, 0.3) == 60 != round(85 * (1 - 0.3))


def test_prune_and_finetune_sweep_matches_reference(ref):
    rng = np.random.default_rng(4)
    ws = [rng.standard_normal((16, 12)).astype(np.float32),
          rng.standard_normal((12, 10)).astype(np.float32)]

    def steps_port(ps, masks, n):
        return [p + 0.5 * n for p in ps], {"n": n}

    def steps_ref(ps, masks, n):
        return [p + 0.5 * n for p in ps], {"n": n}
    got = S.prune_and_finetune_sweep([torch.from_numpy(w) for w in ws],
                                     steps_port, [0.25, 0.75],
                                     finetune_steps=3)
    want = ref.pruning.prune_and_finetune_sweep(
        [jnp.asarray(w) for w in ws], steps_ref, [0.25, 0.75],
        finetune_steps=3)
    for (s1, p1, m1), (s2, p2, m2) in zip(got, want):
        assert s1 == s2 and m1 == m2
        for a, b in zip(p1, p2):
            assert np.array_equal(_np(a), np.asarray(b))


# ------------------------------------------------------------- regularizers

def _acts(seed=0):
    rng = np.random.default_rng(seed)
    return [np.maximum(rng.standard_normal(shape), 0).astype(np.float32)
            for shape in ((16, 48), (16, 32), (16, 24))]


REG_CASES = {
    "tl1": lambda m, a: m.tl1_regularizer(a),
    "tl1_a0.3": lambda m, a: m.tl1_regularizer(a, a=0.3),
    "tl1_weighted": lambda m, a: m.tl1_regularizer(
        a, weights=(0.5, 1.7, 0.8)),
    "synops_abs": lambda m, a: m.synops_loss(a, [32, 24, 10]),
    "synops_abs_weighted": lambda m, a: m.synops_loss(
        a, [32, 24, 10], weights=(2.0, 0.25, 0.75)),
    "synops_count": lambda m, a: m.synops_loss(a, [32, 24, 10],
                                               surrogate="count"),
    "synops_count_weighted": lambda m, a: m.synops_loss(
        a, [32, 24, 10], surrogate="count", weights=(1.5, 1.0, 0.5)),
}


class _Float64:
    """The regularizers' formulas in float64 numpy: the yardstick for the
    roundoff of both float32 implementations."""

    @staticmethod
    def tl1_regularizer(acts, a=1.0, weights=None):
        ts = [(a + 1.0) * np.abs(x) / (a + np.abs(x))
              for x in (np.asarray(x, np.float64) for x in acts)]
        if weights is None:
            return sum(t.sum() for t in ts) / sum(t.size for t in ts)
        return sum(w * t.mean() for w, t in zip(weights, ts)) / len(ts)

    @staticmethod
    def synops_loss(acts, fanouts, surrogate="abs", weights=None):
        xs = [np.asarray(x, np.float64) for x in acts]
        ts = [np.abs(x) if surrogate == "abs" else (x > 0).astype(float)
              for x in xs]
        weights = weights or [1.0] * len(ts)
        return sum(w * f * t.mean() for t, f, w in
                   zip(ts, fanouts, weights)) / sum(fanouts[:len(ts)])


@pytest.mark.parametrize("case", sorted(REG_CASES))
def test_regularizer_values_and_gradients(ref, case):
    fn = REG_CASES[case]
    acts = _acts()
    # signed inputs too: |x| and its slope at 0 follow JAX
    acts[1] = acts[1] - 0.25 * (acts[1] == 0)
    want, want_g = jax.value_and_grad(lambda a: fn(ref.regularizers, a))(
        [jnp.asarray(a) for a in acts])
    xs = [torch.from_numpy(a).requires_grad_(True) for a in acts]
    got = fn(S.regularizers, xs)
    got_g = torch.autograd.grad(got, xs)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), fn(_Float64, acts), rtol=1e-6)
    np.testing.assert_allclose(float(got), float(want), rtol=REG_RTOL)
    for g, w in zip(got_g, want_g):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=0.0)


@pytest.mark.parametrize("thresh", [0.0, 0.5])
def test_activation_density_matches_reference(ref, thresh):
    acts = _acts(1)
    got_l, got_t = S.activation_density([torch.from_numpy(a) for a in acts],
                                        thresh)
    want_l, want_t = ref.regularizers.activation_density(
        [jnp.asarray(a) for a in acts], thresh)
    assert [float(x) for x in got_l] == [float(x) for x in want_l]
    np.testing.assert_allclose(float(got_t), float(want_t), rtol=1e-6)


# --------------------------------------------------------------------- data

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 10_999),
                                       (11, 10_000)])
def test_data_batches_bit_identical(ref, seed, step):
    R = ref.train_data
    pairs = [
        (D.SyntheticImages(hw=4, channels=2, global_batch=8, seed=seed),
         R.SyntheticImages(hw=4, channels=2, global_batch=8, seed=seed)),
        (D.SyntheticDenoise(n_features=12, seq_len=24, global_batch=3,
                            seed=seed),
         R.SyntheticDenoise(n_features=12, seq_len=24, global_batch=3,
                            seed=seed)),
        (D.SyntheticLM(D.LMTaskConfig(vocab_size=50, seq_len=9,
                                      global_batch=4, seed=seed)),
         R.SyntheticLM(R.LMTaskConfig(vocab_size=50, seq_len=9,
                                      global_batch=4, seed=seed))),
    ]
    for mine, theirs in pairs:
        a, b = mine.batch(step), theirs.batch(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            assert np.array_equal(a[k], b[k])
    lm, lm_r = pairs[2]
    for k, v in lm.batch_for_host(step, 1, 2).items():
        assert np.array_equal(v, lm_r.batch_for_host(step, 1, 2)[k])


# ------------------------------------------------------------ normal, init

@pytest.mark.parametrize("seed", [0, 3, 7])
def test_normal_within_two_ulp_only_in_the_tails(seed):
    n = 1 << 18
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n,)))
    got = _np(prng.normal(prng.PRNGKey(seed), (n,)))
    d = _ulps(got, want)
    assert d.max() <= 2
    # u = erf(z / sqrt 2) with -log1p(-u*u) >= 5 means |z| > 2.9
    assert np.all(np.abs(want[d != 0]) > 2.9)
    assert np.count_nonzero(d) <= 20


@pytest.mark.parametrize("seed,sizes", [(0, SIZES), (5, (128, 192, 128, 10)),
                                        (2, (24, 7))])
def test_mlp_init_within_two_ulp(ref, seed, sizes):
    want = ref.train_sparse.mlp_init(jax.random.PRNGKey(seed), sizes)
    got = T.mlp_init(prng.PRNGKey(seed), sizes, device="cpu")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert _ulps(_np(g), w).max() <= 2


# ------------------------------------------------------------- the trainer

def test_trainer_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        T.SparseTrainer(_cfg(T))
    assert T.SparseTrainer(_cfg(T), device="cpu").device.type == "cpu"


def test_trainer_validation():
    with pytest.raises(ValueError, match="finetune_steps"):
        _cfg(T, prune_sparsity=0.5)
    with pytest.raises(ValueError, match="layer_weights"):
        T.SparseTrainer(_cfg(T), layer_weights=[1.0], device="cpu")
    with pytest.raises(ValueError, match="ckpt_dir"):
        T.SparseTrainer(_cfg(T), device="cpu").train(resume=True)
    with pytest.raises(ValueError, match="2\\*hw"):
        T.SparseTrainer(_cfg(T, sizes=(30, 10)), device="cpu")
    with pytest.raises(ValueError, match="task"):
        T.SparseTrainer(_cfg(T, task="lm"), device="cpu")


UPDATE_CASES = {
    "dense": dict(),
    "tl1_guided": dict(lam=0.05, layer_weights=(1.4, 0.6)),
    "synops": dict(lam=0.1, reg="synops"),
    "pruned": dict(lam=0.05, prune_sparsity=0.5, finetune_steps=4,
                   min_prune_size=1, steps=3),
    "denoise": dict(task="denoise", sizes=(16, 24, 16), batch=16, lam=0.02),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_one_update_from_identical_state(ref, case):
    kw = dict(UPDATE_CASES[case])
    lw = kw.pop("layer_weights", None)
    kw.setdefault("steps", 4)
    rt = ref.train_sparse.SparseTrainer(_cfg(ref.train_sparse, **kw),
                                        layer_weights=lw)
    rt.train(stop_after=5)          # past the prune boundary when pruning
    pt = _carry(rt, layer_weights=lw, **kw)
    batch_r = rt._batch(rt.step)
    batch_p = pt._batch(pt.step)
    for a, b in zip(batch_p, batch_r):
        assert np.array_equal(_np(a), np.asarray(b))
    # gradients at the masked parameters, before the Adam step
    pz_r = [w * k for w, k in zip(rt.params, rt.masks)]
    l_r, g_r = jax.value_and_grad(rt._loss)(pz_r, batch_r)
    pz_p = [w * k for w, k in zip(pt.params, pt.masks)]
    l_p, g_p = pt._grads(pz_p, batch_p)
    np.testing.assert_allclose(float(l_p), float(l_r), rtol=1e-6)
    for a, b in zip(g_p, g_r):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    new_r = rt._update(rt.params, rt.opt_m, rt.opt_v, rt.masks, batch_r)
    new_p = pt._update(pt.params, pt.opt_m, pt.opt_v, pt.masks, batch_p)
    np.testing.assert_allclose(float(new_p[3]), float(new_r[3]), rtol=1e-6)
    for got, want in zip(new_p[:3], new_r[:3]):
        for a, b in zip(got, want):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0.0,
                                       atol=STEP_ATOL)
    # pruned entries stay exactly zero
    for a, k in zip(new_p[0], pt.masks):
        assert not bool((a[k == 0] != 0).any())


@pytest.mark.parametrize("n_layers", [3, 10])
def test_prune_boundary_masks_identical(ref, n_layers):
    """The reference takes its masks as the leaves of {"w0": .., ...}; up
    to 10 layers that is layer order, so the masks agree exactly."""
    sizes = (32,) + (12,) * (n_layers - 1) + (10,)
    kw = dict(sizes=sizes, steps=3, lam=0.05, prune_sparsity=0.6,
              finetune_steps=2, min_prune_size=1)
    rt = ref.train_sparse.SparseTrainer(_cfg(ref.train_sparse, **kw))
    rt.train(stop_after=3)
    pt = _carry(rt, **kw)
    rt.train(stop_after=4)
    pt.train(stop_after=4)
    assert len(pt.masks) == n_layers
    for a, b in zip(pt.masks, rt.masks):
        assert np.array_equal(_np(a), np.asarray(b))
        assert int(a.sum()) == S.pruning._kept(a.numel(), 0.6)


def test_masks_stay_in_layer_order_past_ten_layers():
    sizes = (8,) + tuple(range(9, 19)) + (10,)          # 11 layers
    pt = T.SparseTrainer(_cfg(T, sizes=sizes, steps=1, prune_sparsity=0.5,
                              finetune_steps=1, min_prune_size=1),
                         device="cpu")
    pt.train(stop_after=2)
    assert [tuple(m.shape) for m in pt.masks] == \
        [tuple(p.shape) for p in pt.params]


def test_floorline_weights_on_identical_weights(ref):
    rt = ref.train_sparse.SparseTrainer(_cfg(ref.train_sparse))
    rt.train(stop_after=6)
    pt = _carry(rt)
    chip = ref.platform.loihi2_like()
    want = rt.floorline_weights(chip, probe_steps=4)
    got = pt.floorline_weights(loihi2_like(), probe_steps=4)
    assert got.shape == (len(SIZES) - 2,) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=0.0)
    assert np.array_equal(pt._probe_xs(4), rt._probe_xs(4))


def test_eval_profile_and_deploy_on_identical_weights(ref):
    kw = dict(steps=6, lam=0.05, prune_sparsity=0.5, finetune_steps=3,
              min_prune_size=1)
    rt = ref.train_sparse.SparseTrainer(_cfg(ref.train_sparse, **kw))
    rt.train()
    pt = _carry(rt, **kw)
    got, want = pt.eval_metrics(), rt.eval_metrics()
    assert got == want
    pa = pt.extract_profile(meta={"config": "x"})
    pb = rt.extract_profile(meta={"config": "x"})
    assert pa.layer_names == pb.layer_names
    assert np.array_equal(pa.act_density, pb.act_density)
    assert np.array_equal(pa.weight_density, pb.weight_density)
    assert pa.input_density == pb.input_density and pa.meta == pb.meta
    for a, b in zip(pa.weight_masks, pb.weight_masks):
        assert np.array_equal(a, b)
    for kw_d in ({}, {"neuron_model": "if"},
                 {"neuron_model": "sd_relu", "thresholds": [0.1, 0.2, 0.3],
                  "sends_deltas": True}):
        na, nb = pt.deploy(**kw_d), rt.deploy(**kw_d)
        assert na.in_size == nb.in_size and na.device.type == "cpu"
        for la, lb in zip(na.layers, nb.layers):
            assert (la.name, la.kind, la.neuron_model, la.threshold,
                    la.sends_deltas) == (lb.name, lb.kind, lb.neuron_model,
                                         lb.threshold, lb.sends_deltas)
            assert np.array_equal(_np(la.weights), np.asarray(lb.weights))


def test_calibrate_sigma_delta_on_identical_weights(ref):
    kw = dict(sizes=(16, 24, 16, 16), task="denoise", steps=15, batch=16)
    rt = ref.train_sparse.SparseTrainer(_cfg(ref.train_sparse, **kw))
    rt.train()
    pt = _carry(rt, **kw)
    for target in (0.4, [0.3, 0.2]):
        pa, na = pt.calibrate_sigma_delta(target)
        pb, nb = rt.calibrate_sigma_delta(target)
        np.testing.assert_allclose(pa.thresholds, pb.thresholds, rtol=1e-6,
                                   atol=0.0)
        assert np.array_equal(pa.act_density, pb.act_density)
        assert np.array_equal(pa.weight_density, pb.weight_density)
        for a, b in zip(pa.weight_masks, pb.weight_masks):
            assert np.array_equal(a, b)
        assert pa.input_density == pb.input_density and pa.meta == pb.meta
        assert [(l.neuron_model, l.sends_deltas) for l in na.layers] == \
            [(l.neuron_model, l.sends_deltas) for l in nb.layers]
        np.testing.assert_allclose([l.threshold for l in na.layers],
                                   [l.threshold for l in nb.layers],
                                   rtol=1e-6, atol=0.0)
    with pytest.raises(ValueError, match="denoise"):
        T.SparseTrainer(_cfg(T), device="cpu").calibrate_sigma_delta(0.1)


@pytest.mark.parametrize("kw", [
    dict(steps=12, lam=0.05, prune_sparsity=0.5, finetune_steps=6,
         min_prune_size=1, ckpt_every=5),
    dict(steps=9, lam=0.1, reg="synops", ckpt_every=4)])
def test_kill_and_resume_bit_identical(tmp_path, kw):
    full = T.SparseTrainer(_cfg(T, ckpt_dir=str(tmp_path / "a"), **kw),
                           device="cpu").train()
    killed = T.SparseTrainer(_cfg(T, ckpt_dir=str(tmp_path / "b"), **kw),
                             device="cpu")
    killed.train(stop_after=8)
    assert killed.step == 8
    resumed = T.SparseTrainer(_cfg(T, ckpt_dir=str(tmp_path / "b"), **kw),
                              device="cpu").train(resume=True)
    assert resumed.step == full.step == full.cfg.total_steps
    assert resumed.losses == full.losses
    for name in ("params", "opt_m", "opt_v", "masks"):
        for a, b in zip(getattr(resumed, name), getattr(full, name)):
            assert torch.equal(a, b)
    pa, pb = resumed.extract_profile(), full.extract_profile()
    assert np.array_equal(pa.act_density, pb.act_density)
    for a, b in zip(pa.weight_masks, pb.weight_masks):
        assert np.array_equal(a, b)


def test_short_run_tracks_the_reference(ref):
    """20 steps (a guided tl1 phase, the prune, a masked fine-tune) from
    the reference's initial weights: the losses stay within RUN_RTOL, the
    masks agree and the held-out accuracy is the same."""
    kw = dict(sizes=(32, 48, 32, 10), steps=14, lam=0.05,
              prune_sparsity=0.5, finetune_steps=6, min_prune_size=1)
    lw = (1.25, 0.75)
    rt = ref.train_sparse.SparseTrainer(_cfg(ref.train_sparse, **kw),
                                        layer_weights=lw)
    pt = _carry(rt, layer_weights=lw, **kw)
    rt.train()
    pt.train()
    assert len(pt.losses) == len(rt.losses) == 20
    np.testing.assert_allclose(pt.losses, rt.losses, rtol=RUN_RTOL, atol=0)
    for a, b in zip(pt.masks, rt.masks):
        assert np.array_equal(_np(a), np.asarray(b))
    assert pt.eval_metrics()["acc"] == rt.eval_metrics()["acc"]
    assert json.loads(json.dumps(pt.losses)) == pt.losses
