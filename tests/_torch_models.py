"""The JAX package's model stack and the port's, run on the same weights.

Shared by the port's model tests.  ``lm_pair`` draws the reference's
``lm.init_params`` from ``PRNGKey(seed)`` and carries the tree across
with ``params_from_numpy``; ``lm_logits`` runs prefill, the full forward
and one decode step in both packages on the same numpy tokens (the
reference's decode cache grown and rolled as its own
``tests/test_models.py`` does).  The reference runs on a one-device mesh
with ``Auto`` axes (``_repro_reference.auto_mesh``).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _repro_reference import auto_mesh
from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.serve.engine import decode_cache

#: float32 smoke configs: logits of the two packages (measured: 4e-6 at
#: most, summation order and XLA's tanh / exp polynomials)
LOGIT_RTOL, LOGIT_ATOL = 1e-5, 2e-5
DECODER_ARCHS = [a for a in registry.ARCH_IDS
                 if not registry.get(a).is_encdec]


def np_(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def ctx(R):
    return R.sharding.make_ctx(auto_mesh())


def decode_cfg(cfg):
    """``cfg`` without a frontend and, for MoE, with drop-free capacity
    (cf = E / k) in prefill and decode: capacity dropping legitimately
    differs between the two token counts (the reference's recipe)."""
    def fix(blk):
        if blk.moe is None:
            return blk
        cf = float(blk.moe.n_experts) / blk.moe.top_k
        return dataclasses.replace(blk, moe=dataclasses.replace(
            blk.moe, capacity_factor=cf, decode_capacity_factor=cf))
    return dataclasses.replace(
        cfg, frontend="none", frontend_tokens=0,
        prefix=tuple(map(fix, cfg.prefix)),
        pattern=tuple(map(fix, cfg.pattern)),
        suffix=tuple(map(fix, cfg.suffix)))


def port_cfg(cfg):
    """The port's dataclass with the fields of the reference's ``cfg``."""
    from repro_torch.models.common import (BlockCfg, ModelCfg, MoECfg,
                                           RGLRUCfg, SSDCfg)
    kinds = {"MoECfg": MoECfg, "SSDCfg": SSDCfg, "RGLRUCfg": RGLRUCfg,
             "BlockCfg": BlockCfg, "ModelCfg": ModelCfg}

    def conv(v):
        if dataclasses.is_dataclass(v):
            return kinds[type(v).__name__](**{
                f.name: conv(getattr(v, f.name))
                for f in dataclasses.fields(v)})
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v
    return conv(cfg)


def lm_pair(R, cfg, seed: int = 2):
    """(reference params, port LM) on the same weights."""
    params = R.lm.init_params(cfg, jax.random.PRNGKey(seed))
    model = lm.params_from_numpy(port_cfg(cfg),
                                 jax.tree.map(np.asarray, params), "cpu")
    return params, model


def lm_logits(R, arch: str, *, B: int = 2, T: int = 12, seed: int = 2
              ) -> dict:
    """Prefill logits (T tokens), forward logits and aux (T + 1 tokens)
    of the smoke config, and decode logits of token T under
    :func:`decode_cfg`, from both packages: ``{name: (ref, port)}``."""
    cfg = R.registry.get(arch).smoke()
    c = ctx(R)
    params, model = lm_pair(R, cfg, seed)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    fe = (rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model))
          .astype(np.float32) if cfg.frontend != "none" else None)
    jfe = None if fe is None else jnp.asarray(fe)
    tfe = None if fe is None else torch.from_numpy(fe)
    t_all = torch.from_numpy(toks).long()

    out = {}
    rl, _ = R.lm.prefill(params, jnp.asarray(toks[:, :T]), cfg, c, jfe)
    pl, _ = lm.prefill(model, t_all[:, :T], tfe)
    out["prefill"] = (np_(rl), np_(pl))
    h, aux = R.lm.forward(params, jnp.asarray(toks), cfg, c, jfe)
    th, taux = lm.forward(model, t_all, tfe)
    out["forward"] = (np_(R.lm.logits_from_h(params, h, cfg, c)),
                      np_(lm.logits_from_h(model, th)))
    for k in lm.AUX_SUM + lm.AUX_MAX:
        out[k] = (np_(aux[k]), np_(taux[k]))

    dcfg = decode_cfg(cfg)
    params, model = lm_pair(R, dcfg, seed)
    _, cache = R.lm.prefill(params, jnp.asarray(toks[:, :T]), dcfg, c)
    windows = {b.window for b in dcfg.all_blocks()
               if b.window is not None and b.window < T}

    def grow(x):                     # full-attention caches T -> T + 1
        for ax in (1, 2):
            if x.ndim > ax + 1 and x.shape[ax] == T:
                pad = [(0, 0)] * x.ndim
                pad[ax] = (0, 1)
                return jnp.pad(x, pad)
        return x

    def roll(x):                     # ring caches: position p at p % W
        for ax in (1, 2):
            if x.ndim > ax + 1 and x.shape[ax] in windows:
                W = x.shape[ax]
                return jnp.roll(x, (T - W) % W, axis=ax)
        return x
    cache = jax.tree.map(roll, jax.tree.map(grow, cache))
    rd, _ = R.lm.decode_step(params, jnp.asarray(toks[:, T:T + 1]), cache,
                             jnp.int32(T), dcfg, c)
    _, pcache = lm.prefill(model, t_all[:, :T])
    pd, _ = lm.decode_step(model, t_all[:, T:T + 1],
                           decode_cache(model.cfg, pcache, T, T + 1), T)
    ph, _ = lm.forward(model, t_all)
    out["decode"] = (np_(rd), np_(pd))
    out["decode_vs_forward"] = (np_(lm.logits_from_h(model, ph)[:, -1]),
                                np_(pd))
    return out


def assert_logits_close(pair, what: str) -> None:
    want, got = pair
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=LOGIT_RTOL, atol=LOGIT_ATOL,
                               err_msg=what)


#: loss_fn of the two packages: the loss within rtol ``LOSS_RTOL``, each
#: gradient leaf within ``GRAD_ATOL`` of its largest entry (float32 sums
#: in another order through the whole backward, as in
#: ``tests/test_torch_train_lm.py``)
LOSS_RTOL, GRAD_ATOL = 1e-6, 2e-5


def out_of_range_labels(labels: np.ndarray, V: int) -> tuple:
    """``labels`` with -1 and ``V`` at two positions of each row, and
    weights that keep one of them (weight 1) and drop the other (0): a
    label outside [0, V) has a log-likelihood of 0 in the reference's
    one-hot sum."""
    labels = labels.copy()
    labels[:, 1], labels[:, -1] = -1, V
    weights = np.ones(labels.shape, np.float32)
    weights[0, 1] = weights[-1, -1] = 0.0
    return labels, weights


def assert_loss_and_grads_match(R, lib_ref, lib_port, cfg, params, model,
                                batch: dict) -> None:
    """The reference's jitted ``value_and_grad`` of ``loss_fn`` against the
    port's ``step.value_and_grad`` on the same numpy ``batch``."""
    from repro_torch.train import step as S

    def leaves(tree, prefix=""):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield prefix + k, v

    c = R.sharding.make_ctx(auto_mesh())
    (total, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: lib_ref.loss_fn(p, b, cfg, c), has_aux=True))(
        params, jax.tree.map(jnp.asarray, batch))
    ptotal, _, pgrads = S.value_and_grad(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(ptotal), float(total), rtol=LOSS_RTOL)
    got = dict(leaves(pgrads))
    want = dict(leaves(jax.tree.map(np.asarray, grads)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(np_(got[k]), w, rtol=0,
                                   atol=GRAD_ATOL * np.abs(w).max(),
                                   err_msg=k)
