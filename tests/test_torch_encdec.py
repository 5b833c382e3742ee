"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper)
against the JAX package's, on the CPU, on carried-across weights in
whisper's float32 smoke config: ``encode``, ``decode_train``, and
``decode_step`` after ``precompute_cross_cache``, token by token.

Tolerances, and why: hidden states and logits rtol 1e-5, atol
``OUT_ATOL`` (float32 sums in another order; measured below 3e-6); the
port's decode steps against its own ``decode_train`` at every position
the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _repro_reference import reference
from _torch_models import (assert_loss_and_grads_match, np_,
                           out_of_range_labels)
from repro_torch.configs import registry
from repro_torch.models import encdec as E

OUT_ATOL = 2e-5


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


@pytest.fixture(scope="module")
def whisper(ref):
    """Both packages' encode, decode_train and per-token decode logits on
    the same weights, frames and tokens."""
    cfg = ref.registry.get("whisper-base").smoke()
    c = ref.layers.ShardCtx()
    params = ref.encdec.init_params(cfg, jax.random.PRNGKey(3))
    model = E.params_from_numpy(registry.get("whisper-base").smoke(),
                                jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(9)
    B, T = 2, 10
    frames = rng.standard_normal((B, cfg.n_frames, cfg.d_model)).astype(
        np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32)
    out = {}
    enc = ref.encdec.encode(params, jnp.asarray(frames), cfg, c)
    penc = E.encode(model, torch.from_numpy(frames))
    out["encode"] = (np_(enc), np_(penc))
    h = ref.encdec.decode_train(params, enc, jnp.asarray(toks), cfg, c)
    ph = E.decode_train(model, penc, torch.from_numpy(toks).long())
    out["decode_train"] = (np_(h), np_(ph))
    out["train_logits"] = (
        np_(jnp.einsum("bsd,dv->bsv", h, params["embed"].T)),
        np_(E.logits_from_h(model, ph)))

    cache = ref.encdec.precompute_cross_cache(
        params, enc, cfg, c, ref.encdec.init_cache(cfg, B, T + 2))
    pcache = E.precompute_cross_cache(
        model, penc, E.init_cache(model.cfg, B, T + 2, "cpu"))
    steps, psteps = [], []
    for t in range(T):
        lg, cache = ref.encdec.decode_step(
            params, jnp.asarray(toks[:, t:t + 1]), cache, jnp.int32(t), cfg,
            c)
        plg, pcache = E.decode_step(model, torch.from_numpy(
            toks[:, t:t + 1]).long(), pcache, t)
        steps.append(np_(lg))
        psteps.append(np_(plg))
    out["decode_step"] = (np.stack(steps, 1), np.stack(psteps, 1))
    return out


@pytest.mark.parametrize("what", ["encode", "decode_train", "train_logits",
                                  "decode_step"])
def test_whisper_matches_reference(whisper, what):
    want, got = whisper[what]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=OUT_ATOL)


def test_whisper_decode_steps_match_decode_train(whisper):
    np.testing.assert_allclose(whisper["decode_step"][1],
                               whisper["train_logits"][1], rtol=1e-5,
                               atol=OUT_ATOL)


def test_encdec_init_params_shapes(ref):
    cfg = ref.registry.get("whisper-base").smoke()
    tree = jax.tree.map(np.asarray, ref.encdec.init_params(
        cfg, jax.random.PRNGKey(0)))
    model = E.init_params(registry.get("whisper-base").smoke(), 0, "cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_count() == sum(v.size for v in
                                         jax.tree.leaves(tree))
    assert (tuple(model.dec[1].xattn.wo.shape)
            == tree["dec"]["xattn"]["wo"].shape[1:])


def test_loss_fn_takes_out_of_range_labels_as_the_reference(ref):
    """``encdec.loss_fn`` and every gradient leaf with labels -1 and V in
    the batch (one kept, one dropped by its weight), whisper's smoke
    config: the decoder's loss goes through ``lm.sharded_xent``."""
    cfg = ref.registry.get("whisper-base").smoke()
    params = ref.encdec.init_params(cfg, jax.random.PRNGKey(5))
    model = E.params_from_numpy(registry.get("whisper-base").smoke(),
                                jax.tree.map(np.asarray, params), "cpu")
    rng = np.random.default_rng(6)
    labels, weights = out_of_range_labels(
        rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32),
        cfg.vocab_size)
    batch = {"frontend_embeds": rng.standard_normal(
                 (2, cfg.n_frames, cfg.d_model)).astype(np.float32),
             "tokens": rng.integers(0, cfg.vocab_size, (2, 8)).astype(
                 np.int32),
             "labels": labels, "weights": weights}
    assert_loss_and_grads_match(ref, ref.encdec, E, cfg, params, model,
                                batch)
