"""The port's decoder-only LM (``repro_torch.models.lm``) against the JAX
package's, on the CPU, on carried-across weights (``params_from_numpy``)
in the float32 smoke configs of the dense archs.  The MoE archs' logits
are held in ``test_torch_moe.py`` and the SSD / RG-LRU archs' in
``test_torch_layers.py``, so that the reference's compiles spread over
test workers.

Tolerances, and why:

* logits rtol ``LOGIT_RTOL``, atol ``LOGIT_ATOL`` (``_torch_models``;
  measured 4e-6 at most): float32 sums in another order and XLA's own
  ``tanh``/``exp`` polynomials;
* the port's decode step against its own forward at the same position:
  the same tolerance (prefill and decode sum in other orders);
* ``init_params``: the reference's shapes, dtypes and constant leaves
  exactly; each drawn leaf's standard deviation within 10% of the
  truncated normal's (0.880 / sqrt(fan_in)) where it has 4096 entries or
  more, and every value within 2 / sqrt(fan_in);
* ``params_from_numpy`` in bfloat16: bit for bit.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _repro_reference import reference
from _torch_models import (DECODER_ARCHS, assert_logits_close,
                           assert_loss_and_grads_match, lm_logits, lm_pair,
                           np_, out_of_range_labels, port_cfg)
from repro_torch.configs import registry
from repro_torch.models import lm
from repro_torch.models.layers import Params

DENSE_ARCHS = ["gemma2-2b", "granite-3-2b", "minicpm-2b", "phi3-medium-14b",
               "pixtral-12b"]
TRUNC_STD = 0.8796256610342398     # std of N(0, 1) truncated to [-2, 2]


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_prefill_forward_decode_match_reference(ref, arch):
    out = lm_logits(ref, arch)
    for what in ("prefill", "forward", "decode", "decode_vs_forward"):
        assert_logits_close(out[what], f"{arch} {what}")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def test_init_params_has_reference_shapes_dtypes_and_scales(ref):
    """Every registry arch's smoke config, plus gemma2 in bfloat16: the
    port's tensors, unstacked, against the reference's tree."""
    cfgs = [ref.registry.get(a).smoke() for a in DECODER_ARCHS]
    cfgs.append(dataclasses.replace(cfgs[0], param_dtype="bfloat16",
                                    compute_dtype="bfloat16"))
    for cfg in cfgs:
        arch = f"{cfg.name} {cfg.param_dtype}"
        tree = jax.tree.map(np.asarray, ref.lm.init_params(
            cfg, jax.random.PRNGKey(0)))
        model = lm.init_params(port_cfg(cfg), 0, "cpu")
        want = dict(_leaves({k: v for k, v in tree.items()
                             if k in ("embed", "final_norm", "unembed")}))
        for i, sub in enumerate(lm._block_slices(cfg, tree)):
            want.update(_leaves(sub, f"blocks.{i}."))
        got = dict(model.named_parameters())
        assert sorted(got) == sorted(want), arch
        fans = {f"{prefix}.{n}" if prefix else n: f
                for prefix, m in model.named_modules()
                if isinstance(m, Params) for n, f in m._fan_in.items()}
        for name, w in want.items():
            g = got[name]
            assert tuple(g.shape) == w.shape, (arch, name)
            assert str(g.dtype).split(".")[1] == str(w.dtype), (arch, name)
            if name not in fans:                  # constant leaves
                np.testing.assert_array_equal(np_(g.float()),
                                              w.astype(np.float32),
                                              err_msg=f"{arch} {name}")
                continue
            bound = 2.0 / math.sqrt(fans[name])
            vals = np_(g.float())
            assert np.abs(vals).max() <= bound * (1 + 1e-2), (arch, name)
            if vals.size >= 4096:
                std = TRUNC_STD / math.sqrt(fans[name])
                assert abs(vals.std() / std - 1) < 0.1, (arch, name)


def test_params_from_numpy_keeps_bfloat16_bits(ref):
    cfg = dataclasses.replace(ref.registry.get("gemma2-2b").smoke(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params, model = lm_pair(ref, cfg)
    assert model.embed.dtype == torch.bfloat16
    got = model.embed.view(torch.int16).numpy()
    want = np.asarray(params["embed"]).view(np.int16)
    np.testing.assert_array_equal(got, want)
    wq = np.asarray(params["pattern"]["blk1"]["attn"]["wq"][1])
    np.testing.assert_array_equal(
        model.blocks[3].attn.wq.view(torch.int16).numpy(), wq.view(np.int16))


def test_bfloat16_prefill_tracks_reference(ref):
    """gemma2's smoke config in bfloat16 (the full config's dtypes): the
    last-position logits of both packages within bf16 roundoff, 2e-2 of
    their largest magnitude (logits are float32 products of bf16
    hidden states and the bf16 embedding)."""
    cfg = dataclasses.replace(ref.registry.get("gemma2-2b").smoke(),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    params, model = lm_pair(ref, cfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 10))
    want, _ = ref.lm.prefill(params, jnp.asarray(toks, jnp.int32), cfg,
                             ref.sharding.make_ctx(None))
    got, _ = lm.prefill(model, torch.from_numpy(toks))
    assert got.dtype == torch.float32
    want = np_(want)
    assert np.abs(np_(got) - want).max() <= 2e-2 * np.abs(want).max()


def test_entry_points_default_to_the_card():
    cfg = registry.get("granite-3-2b").smoke()
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(cfg, 1, 4)


@pytest.mark.parametrize("bad", [-1, 5])
def test_sharded_xent_takes_out_of_range_labels_as_the_reference(ref, bad):
    """A label outside [0, V) has a log-likelihood of 0, as in the
    reference's one-hot sum: the values of ROADMAP's repro 1, and the
    gradients of both outputs (softmax times the weight, no -1 term, where
    such a label is kept)."""
    logits = np.random.default_rng(0).standard_normal((1, 3, 5)).astype(
        np.float32)
    labels = np.array([[0, 1, bad]], np.int32)
    for w in ([[1.0, 1.0, 0.0]], [[1.0, 1.0, 1.0]]):
        weights = np.array(w, np.float32)
        x = torch.from_numpy(logits).requires_grad_()
        got = lm.sharded_xent(x, torch.from_numpy(labels),
                              torch.from_numpy(weights))
        for i in range(2):
            want, grad = jax.value_and_grad(
                lambda l: ref.lm.sharded_xent(l, labels, weights)[i])(
                jnp.asarray(logits))
            g, = torch.autograd.grad(got[i], x, retain_graph=True)
            np.testing.assert_allclose(float(got[i].detach()), float(want),
                                       rtol=1e-6)
            np.testing.assert_allclose(np_(g), np.asarray(grad), rtol=1e-6,
                                       atol=1e-7)
        if w[0][2] == 0.0:
            np.testing.assert_allclose([float(v.detach()) for v in got],
                                       [1.2153597, 3.7685568], rtol=1e-6)


def test_loss_fn_takes_out_of_range_labels_as_the_reference(ref):
    """``lm.loss_fn`` and every gradient leaf with labels -1 and V in the
    batch (one kept, one dropped by its weight), on granite's smoke
    config."""
    cfg = ref.registry.get("granite-3-2b").smoke()
    params, model = lm_pair(ref, cfg)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    labels, weights = out_of_range_labels(
        rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32),
        cfg.vocab_size)
    assert_loss_and_grads_match(ref, ref.lm, lm, cfg, params, model, {
        "tokens": toks, "labels": labels, "weights": weights})
