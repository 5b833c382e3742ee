"""The port's optimizers, schedules and train steps (``repro_torch.train.
{optim,schedules,step}``, ``repro_torch.distributed.collectives``) against
the JAX package's, on the CPU.

The optimizers get the same gradients in both packages, in the
reference's leaf layout (``step.param_tree``: a pattern leaf holds its R
repeats stacked), so only their arithmetic differs.  The reference's
update runs jitted, as its train step runs it.

Tolerances, and why:

* schedules: rtol ``SCHED_RTOL`` (float32; XLA's ``cos`` polynomial
  against the host's, and its FMA contraction);
* optimizer states and parameters after each of 3 steps: rtol
  ``OPT_RTOL``, atol ``OPT_ATOL`` (float32, a handful of roundings per
  element; Adafactor's means sum in another order);
* ``clip_by_global_norm`` on bfloat16 gradients: within one bfloat16 ulp
  (the global norm sums in another order, so the scale may differ in its
  last float32 bit);
* train steps on carried-across weights (``params_from_numpy``):
  float32 parameters after a step within ``STEP_ATOL`` times the
  learning rate of the reference's (Adam's first update is
  ``lr * g / (|g| + eps)``, so a gradient near zero that differs by ``d``
  moves its parameter by up to ``lr * d / eps``); bfloat16 as its test
  states;
* the int8 quantizer and the one-replica compressed mean bit for bit (a
  product with XLA's float32 reciprocal of 127, then ``round`` half to
  even), its error within an ulp; the compressed step as its test
  states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _repro_reference import auto_mesh, reference
from _torch_models import np_, port_cfg
from repro_torch.distributed import collectives as C
from repro_torch.models import lm
from repro_torch.train import optim, schedules
from repro_torch.train import step as S
from repro_torch.tree import tree_leaves, tree_map

SCHED_RTOL = 1e-6
OPT_RTOL, OPT_ATOL = 1e-5, 1e-7
STEP_ATOL = 0.1             # of lr; measured 0.037
BF16_ULP = 2.0 ** -7
BF16_GRAD_ATOL = 3e-2       # of a leaf's largest gradient; measured 0.016
BF16_FLIPS = 0.02           # share of a leaf; measured 0.0078
ERR_ATOL = 1e-6             # compressed step's error; measured 1.4e-7
ERR_FLIPS = 1e-3            # share of a leaf; measured 6e-5


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _paths(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def assert_trees_close(got, want, rtol, atol, what):
    g, w = dict(_paths(got)), dict(_paths(want))
    assert sorted(g) == sorted(w), what
    for k in w:
        a, b = np_(g[k]).astype(np.float32), np.asarray(w[k], np.float32)
        assert a.shape == b.shape, f"{what} {k}"
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-3,)), ("linear_warmup", (3e-3, 10)),
    ("cosine", (3e-3, 5, 40)), ("wsd", (1e-2, 4, 30, 12))])
def test_schedules_match_reference_jitted(ref, name, args):
    want_fn = jax.jit(getattr(ref.schedules, name)(*args))
    got_fn = getattr(schedules, name)(*args)
    steps = range(51)
    want = np.array([float(want_fn(jnp.int32(i))) for i in steps])
    got = np.array([got_fn(torch.tensor(i, dtype=torch.int32)).item()
                    for i in steps])
    assert got_fn(torch.tensor(0)).dtype == torch.float32
    np.testing.assert_allclose(got, want, rtol=SCHED_RTOL, atol=0)


def _granite(ref, seed=0):
    """The reference's granite smoke params and the port's model on the
    same weights, every norm gamma set to nonzero values (they start at
    0, where weight decay cannot show)."""
    cfg = ref.registry.get("granite-3-2b").smoke()
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(np.asarray, ref.lm.init_params(
        cfg, jax.random.PRNGKey(seed)))

    def gammas(path, x):
        name = jax.tree_util.keystr(path)
        return (rng.uniform(0.5, 1.5, x.shape).astype(x.dtype)
                if "norm" in name else x)
    tree = jax.tree_util.tree_map_with_path(gammas, tree)
    return cfg, tree, lm.params_from_numpy(port_cfg(cfg), tree, "cpu")


def _grads(tree, rng, scale=1e-2):
    return jax.tree.map(lambda x: (rng.standard_normal(x.shape) * scale)
                        .astype(np.float32), tree)


def _run_both(ref, ref_opt, port_opt, tree, params, grads_seq):
    """Both optimizers over ``grads_seq`` -> [(ref (params, state), port
    (params, state)) after each step], as numpy."""
    upd = jax.jit(ref_opt.update)
    rp, rs = jax.tree.map(jnp.asarray, tree), ref_opt.init(
        jax.tree.map(jnp.asarray, tree))
    ps = port_opt.init(params)
    out = []
    for i, g in enumerate(grads_seq):
        rp, rs = upd(jax.tree.map(jnp.asarray, g), rs, rp, jnp.int32(i))
        params, ps = port_opt.update(
            tree_map(torch.from_numpy, g), ps, params,
            torch.tensor(i, dtype=torch.int32))
        out.append(((jax.tree.map(np.asarray, rp),
                     jax.tree.map(np.asarray, rs)),
                    (tree_map(_snap, params), tree_map(_snap, ps))))
    return out


def _snap(t: torch.Tensor) -> np.ndarray:
    """A copy: ``.numpy()`` of a CPU tensor shares its memory."""
    return np_(t).copy()


def test_adamw_three_steps_match_reference_with_stacked_decay(ref):
    """granite smoke (n_repeats 2), weight decay 0.1: params, m, v and
    master after each of 3 steps.  Then one step from zero gradients on
    a fresh state, where the update is weight decay alone: the pattern
    blocks' (R, d) norms decay by lr * 0.1 and ``final_norm`` (d,) does
    not, in both packages."""
    cfg, tree, model = _granite(ref)
    params = S.param_tree(model)
    rng = np.random.default_rng(1)
    lr = 1e-2
    kw = dict(weight_decay=0.1)
    steps = _run_both(ref, ref.optim.adamw(ref.schedules.constant(lr), **kw),
                      optim.adamw(schedules.constant(lr), **kw), tree,
                      params, [_grads(tree, rng) for _ in range(3)])
    for i, ((rp, rs), (pp, ps)) in enumerate(steps):
        assert_trees_close(pp, rp, OPT_RTOL, OPT_ATOL, f"step {i} params")
        assert_trees_close(ps, rs, OPT_RTOL, OPT_ATOL, f"step {i} state")

    cfg, tree, model = _granite(ref, seed=3)
    zero = jax.tree.map(np.zeros_like, tree)
    (rp, _), (pp, _) = _run_both(
        ref, ref.optim.adamw(ref.schedules.constant(lr), **kw),
        optim.adamw(schedules.constant(lr), **kw), tree,
        S.param_tree(model), [zero])[0]
    norm1 = tree["pattern"]["blk0"]["norm1"]
    assert norm1.shape == (cfg.n_repeats, cfg.d_model)
    for got in (pp, rp):
        np.testing.assert_allclose(got["pattern"]["blk0"]["norm1"],
                                   norm1 * (1 - lr * 0.1), rtol=1e-6)
        np.testing.assert_array_equal(got["final_norm"], tree["final_norm"])


def test_adafactor_three_steps_match_reference(ref):
    """granite smoke with ``min_dim_factored=32`` (the embedding and MLP
    leaves factored, attention leaves not) and weight decay 0.1."""
    cfg, tree, model = _granite(ref)
    rng = np.random.default_rng(2)
    kw = dict(min_dim_factored=32, weight_decay=0.1)
    ropt = ref.optim.adafactor(ref.schedules.constant(1e-2), **kw)
    popt = optim.adafactor(schedules.constant(1e-2), **kw)
    params = S.param_tree(model)
    st = popt.init(params)
    assert set(st["fac"]["embed"]) == {"vr", "vc"}
    assert set(st["fac"]["pattern"]["blk0"]["attn"]["wq"]) == {"v"}
    steps = _run_both(ref, ropt, popt, tree, params,
                      [_grads(tree, rng) for _ in range(3)])
    for i, ((rp, rs), (pp, ps)) in enumerate(steps):
        assert_trees_close(pp, rp, OPT_RTOL, OPT_ATOL, f"step {i} params")
        assert_trees_close(ps, rs, OPT_RTOL, OPT_ATOL, f"step {i} state")


def test_adafactor_clips_by_rms_over_the_stacked_leaf(ref):
    """Two repeats of one leaf: block 0's second gradient is 100x its
    first, block 1's 1/100.  Over the stacked leaf the update's rms stays
    below the threshold, so nothing is clipped; block 0 alone would be
    clipped.  Port and reference agree; a per-block optimizer would
    not."""
    rng = np.random.default_rng(4)
    w = {"pattern": {"blk0": {"w": rng.standard_normal((2, 4, 8)).astype(
        np.float32)}}}
    g1 = rng.standard_normal((2, 4, 8)).astype(np.float32)
    g2 = g1 * np.array([100.0, 0.01], np.float32)[:, None, None]
    grads = [{"pattern": {"blk0": {"w": g}}} for g in (g1, g2)]
    ropt = ref.optim.adafactor(ref.schedules.constant(1e-2))
    popt = optim.adafactor(schedules.constant(1e-2))
    params = tree_map(lambda x: torch.from_numpy(x.copy()), w)
    (rp, rs), (pp, ps) = _run_both(ref, ropt, popt, w, params, grads)[-1]
    assert_trees_close(pp, rp, OPT_RTOL, OPT_ATOL, "params")
    assert_trees_close(ps, rs, OPT_RTOL, OPT_ATOL, "state")
    # block 0 on its own: the same steps as a leaf of its own
    alone = {"w": torch.from_numpy(w["pattern"]["blk0"]["w"][0].copy())}
    st = popt.init(alone)
    for i, g in enumerate(grads):
        alone, st = popt.update({"w": torch.from_numpy(
            g["pattern"]["blk0"]["w"][0])}, st, alone,
            torch.tensor(i, dtype=torch.int32))
    step_stacked = pp["pattern"]["blk0"]["w"][0] - w["pattern"]["blk0"]["w"][0]
    step_alone = np_(alone["w"]) - w["pattern"]["blk0"]["w"][0]
    assert np.abs(step_alone).max() < 0.9 * np.abs(step_stacked).max()


def test_clip_rounds_bf16_gradients_as_the_reference(ref):
    rng = np.random.default_rng(5)
    g = {"a": rng.standard_normal((64, 32)).astype(np.float32) * 3,
         "b": {"c": rng.standard_normal(100).astype(np.float32)}}
    jg = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), g)
    want, wnorm = jax.jit(lambda t: ref.optim.clip_by_global_norm(t, 1.0))(jg)
    tg = tree_map(lambda x: torch.from_numpy(x).to(torch.bfloat16), g)
    got, norm = optim.clip_by_global_norm(tg, 1.0)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(got))
    np.testing.assert_allclose(norm.item(), float(wnorm), rtol=1e-6)
    for x, y in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(y, np.float32),
                                   rtol=BF16_ULP, atol=0)


def _batch(cfg, B, S_, seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S_)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S_)).astype(
                np.int32)}


def _ref_step(ref, cfg, tree, opt, batch, M):
    ctx = ref.sharding.make_ctx(auto_mesh())
    params = jax.tree.map(jnp.asarray, tree)
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    fn = jax.jit(ref.step.make_train_step(cfg, ctx, opt,
                                          num_microbatches=M))
    state, metrics = fn(state, jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, state["params"]), {
        k: float(v) for k, v in metrics.items()}


def _port_step(cfg, tree, lr, batch, M):
    """One port AdamW step -> (state, metrics, the dtypes of the gradients
    that reached the optimizer, those gradients)."""
    model = lm.params_from_numpy(port_cfg(cfg), tree, "cpu")
    opt = optim.adamw(schedules.constant(lr))
    seen = []

    def spy(grads, *rest):
        seen.append(tree_map(lambda g: g.detach().clone(), grads))
        return opt.update(grads, *rest)
    state = S.init_state(model, opt)
    step = S.make_train_step(model, optim.Optimizer("adamw", opt.init, spy),
                             num_microbatches=M)
    state, metrics = step(state, tree_map(torch.from_numpy, batch))
    assert int(state["step"]) == 1 and len(seen) == 1
    return state, metrics, seen[0]


def _granite_dtype(ref, dtype):
    cfg = dataclasses.replace(ref.registry.get("granite-3-2b").smoke(),
                              param_dtype=dtype, compute_dtype=dtype)
    return cfg, jax.tree.map(np.asarray, ref.lm.init_params(
        cfg, jax.random.PRNGKey(0)))


@pytest.mark.parametrize("M", [1, 2])
def test_train_step_matches_reference(ref, M):
    """One AdamW step of granite smoke in float32 on carried-across
    weights, with one microbatch and with two (float32 accumulators,
    divided by 2)."""
    cfg, tree = _granite_dtype(ref, "float32")
    batch = _batch(cfg, 4, 16, seed=6)
    lr = 1e-3
    want, wm = _ref_step(ref, cfg, tree, ref.optim.adamw(
        ref.schedules.constant(lr)), batch, M)
    state, metrics, grads = _port_step(cfg, tree, lr, batch, M)
    assert {g.dtype for g in tree_leaves(grads)} == {torch.float32}
    for k, v in wm.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=2e-6,
                                   atol=1e-7, err_msg=k)
    assert_trees_close(tree_map(np_, state["params"]), want, 0,
                       STEP_ATOL * lr, "params")


def test_bf16_train_step_rounds_clipped_gradients(ref):
    """granite smoke in bfloat16, one microbatch: the gradients reach the
    optimizer in bfloat16, the parameters' dtype, so its
    ``clip_by_global_norm`` rounds the clipped ones to bfloat16 (as the
    reference's does; ``test_clip_rounds_bf16_gradients_as_the_reference``).
    They are within ``BF16_GRAD_ATOL`` of their leaf's largest gradient in
    the reference: both packages round every bfloat16 op, XLA after
    fusing some in float32.  Adam's
    first update is lr * g / (|g| + eps), so an element whose bfloat16
    gradient changes sign between the packages moves by 2 lr: every
    parameter within that (plus an ulp), and all but ``BF16_FLIPS`` of
    each leaf within an ulp plus ``STEP_ATOL`` of the reference's."""
    cfg, tree = _granite_dtype(ref, "bfloat16")
    batch = _batch(cfg, 4, 16, seed=6)
    lr = 1e-3
    want, wm = _ref_step(ref, cfg, tree, ref.optim.adamw(
        ref.schedules.constant(lr)), batch, 1)
    ctx = ref.sharding.make_ctx(auto_mesh())
    wgrads = jax.jit(lambda p, b: jax.grad(
        lambda p: ref.lm.loss_fn(p, b, cfg, ctx)[0])(p))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, batch))
    state, metrics, grads = _port_step(cfg, tree, lr, batch, 1)
    np.testing.assert_allclose(float(metrics["loss"]), wm["loss"], rtol=1e-3)
    g = dict(_paths(grads))
    for k, w in _paths(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                    wgrads)):
        assert g[k].dtype == torch.bfloat16, k
        np.testing.assert_allclose(g[k].float().numpy(), w, rtol=0,
                                   atol=BF16_GRAD_ATOL * np.abs(w).max(),
                                   err_msg=k)
    got = dict(_paths(tree_map(lambda t: t.detach().float().numpy(),
                               state["params"])))
    for k, w in _paths(want):
        w = np.asarray(w, np.float32)
        d = np.abs(got[k] - w)
        ulp = BF16_ULP * np.abs(w)
        assert (d <= 2 * lr * 1.01 + ulp).all(), k
        assert (d > STEP_ATOL * lr + ulp).mean() <= BF16_FLIPS, k


def test_quantize_int8_matches_reference(ref):
    rng = np.random.default_rng(7)
    for scale in (1e-3, 1.0, 50.0):
        x = (rng.standard_normal((33, 17)) * scale).astype(np.float32)
        q, s = jax.jit(ref.collectives.quantize_int8)(jnp.asarray(x))
        tq, ts = C.quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q))
        assert ts.item() == float(s)
        np.testing.assert_array_equal(
            C.dequantize_int8(tq, ts).numpy(),
            np.asarray(ref.collectives.dequantize_int8(q, s)))


def _shard_map_1(fn):
    """``fn`` under ``shard_map`` on a one-device ("data",) mesh, jitted:
    the reference's collectives need the axis."""
    from jax.sharding import PartitionSpec as P
    mesh = jax.make_mesh((1,), ("data",), devices=jax.devices()[:1])
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=P(), out_specs=P(),
                                 check_vma=False))


def test_compressed_grad_mean_matches_reference(ref):
    """The same gradients and error trees, two rounds (the second
    re-injects the first's error): means bit for bit; errors within an
    ulp of the leaf's largest value (XLA contracts ``x - q * scale`` into
    one FMA, the port rounds the product first)."""
    rng = np.random.default_rng(9)
    tree = {"a": rng.standard_normal((40, 24)).astype(np.float32),
            "b": {"c": rng.standard_normal(70).astype(np.float32) * 1e-4}}
    fn = _shard_map_1(lambda g, e: ref.collectives.compressed_grad_mean(
        g, e, ("data",)))
    werr = jax.tree.map(np.zeros_like, tree)
    perr = C.init_error_feedback(tree_map(torch.from_numpy, tree))
    for i in range(2):
        g = jax.tree.map(lambda x: x * (1 + i), tree)
        wmean, werr = jax.tree.map(np.asarray, fn(g, werr))
        pmean, perr = C.compressed_grad_mean(tree_map(torch.from_numpy, g),
                                             perr)
        for x, y in zip(tree_leaves(pmean), jax.tree.leaves(wmean)):
            np.testing.assert_array_equal(x.numpy(), y)
        for x, y, v in zip(tree_leaves(perr), jax.tree.leaves(werr),
                           jax.tree.leaves(g)):
            np.testing.assert_allclose(x.numpy(), y, rtol=0,
                                       atol=2.0 ** -23 * np.abs(v).max())


def test_compressed_step_matches_reference(ref):
    """The reference's ``make_dp_compressed_step`` on a one-device mesh
    (under ``shard_map``) against the port's one-replica step, twice.
    Parameters as the other float32 steps.  An error is the residual of a
    rounding to a multiple of the leaf's quantization step, so a gradient
    an ulp away moves it by one step where ``x / scale`` lies on a
    half-way point: every error within ``ERR_ATOL`` of the reference's,
    but for at most ``ERR_FLIPS`` of a leaf, which lie within one step
    (twice the larger error) of it."""
    from repro_torch.train.loop import make_dp_compressed_step
    cfg = ref.registry.get("granite-3-2b").smoke()
    tree = jax.tree.map(np.asarray, ref.lm.init_params(
        cfg, jax.random.PRNGKey(0)))
    lr = 1e-3
    ropt = ref.optim.adamw(ref.schedules.constant(lr))
    ctx = ref.sharding.make_ctx(auto_mesh())
    rstep = jax.jit(ref.loop.make_dp_compressed_step(cfg, ctx, ropt))
    params = jax.tree.map(jnp.asarray, tree)
    rstate = {"params": params, "opt": ropt.init(params),
              "err": ref.collectives.init_error_feedback(params),
              "step": jnp.zeros((), jnp.int32)}

    model = lm.params_from_numpy(port_cfg(cfg), tree, "cpu")
    popt = optim.adamw(schedules.constant(lr))
    pstate = S.init_state(model, popt)
    pstate["err"] = C.init_error_feedback(pstate["params"])
    pstep = make_dp_compressed_step(model, popt)
    for i in range(2):
        batch = _batch(cfg, 4, 16, seed=8 + i)
        rstate, rm = rstep(rstate, jax.tree.map(jnp.asarray, batch))
        pstate, pm = pstep(pstate, tree_map(torch.from_numpy, batch))
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=2e-6)
        assert_trees_close(tree_map(np_, pstate["params"]),
                           jax.tree.map(np.asarray, rstate["params"]), 0,
                           STEP_ATOL * lr, f"step {i} params")
        got = dict(_paths(tree_map(np_, pstate["err"])))
        for k, w in _paths(jax.tree.map(np.asarray, rstate["err"])):
            d = np.abs(got[k] - w)
            step = 2 * max(np.abs(w).max(), np.abs(got[k]).max())
            assert (d <= step + ERR_ATOL).all(), f"step {i} err {k}"
            assert (d > ERR_ATOL).mean() <= ERR_FLIPS, f"step {i} err {k}"
