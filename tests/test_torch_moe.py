"""The port's mixture-of-experts block (``repro_torch.models.moe``)
against the JAX package's single-device body, on the CPU, in float32;
then the logits of the two MoE archs' smoke configs (kimi-k2, olmoe).

The reference's ``moe`` needs a mesh: it runs on a one-device mesh with
``Auto`` axes (``_repro_reference.auto_mesh``), so its collectives are
identities.

Tolerances, and why:

* outputs rtol 1e-5, atol ``OUT_ATOL`` (float32 sums in another order);
* the aux values: the largest and mean expert load exactly (the same
  top-k choices and slots on these inputs); the dropped fraction and the
  load-balance and z losses rtol 1e-6 (float32 means: XLA multiplies by
  the reciprocal of the count, and the LM sums them over layers);
* logits: ``_torch_models.LOGIT_RTOL`` / ``LOGIT_ATOL``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _repro_reference import reference
from _torch_models import (assert_logits_close, ctx, lm_logits, np_,
                           port_cfg)
from repro_torch.models import layers as L
from repro_torch.models import moe as M

OUT_ATOL = 1e-5
MOE_ARCHS = ["kimi-k2-1t-a32b", "olmoe-1b-7b"]
AUX = ("moe_lb_loss", "moe_z_loss", "max_expert_load", "mean_expert_load",
       "dropped_frac")


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


@pytest.mark.parametrize("arch,cf,decode", [
    ("kimi-k2-1t-a32b", None, False),    # shared expert, smoke cf 2.0
    ("olmoe-1b-7b", 0.5, False),         # tight capacity: tokens dropped
    ("olmoe-1b-7b", 0.5, True),          # decode_capacity_factor
])
def test_moe_matches_reference(ref, arch, cf, decode):
    cfg = ref.registry.get(arch).smoke()
    m = next(b.moe for b in cfg.all_blocks() if b.moe is not None)
    if cf is not None:
        m = dataclasses.replace(m, capacity_factor=cf)
    params = ref.moe.moe_params(ref.layers.KeyGen(jax.random.PRNGKey(8)),
                                cfg, m, jnp.float32)
    p = M.MoE(port_cfg(cfg), port_cfg(m), torch.float32, "cpu")
    L.load_tree(p, jax.tree.map(np.asarray, params))
    S = 1 if decode else 9
    x = np.random.default_rng(S).standard_normal(
        (3, S, cfg.d_model)).astype(np.float32)
    want, waux = ref.moe.moe(jnp.asarray(x), params, m, cfg, ctx(ref),
                             decode=decode)
    got, gaux = M.moe(torch.from_numpy(x), p, port_cfg(m), port_cfg(cfg),
                      decode=decode)
    np.testing.assert_allclose(np_(got), np_(want), rtol=1e-5,
                               atol=OUT_ATOL)
    assert sorted(gaux) == sorted(AUX)
    for k in ("max_expert_load", "mean_expert_load"):
        assert float(gaux[k]) == float(waux[k]), k
    for k in ("moe_lb_loss", "moe_z_loss", "dropped_frac"):
        np.testing.assert_allclose(float(gaux[k]), float(waux[k]),
                                   rtol=1e-6, err_msg=k)
    if cf is not None and not decode:
        assert float(gaux["dropped_frac"]) > 0.0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_archs_match_reference(ref, arch):
    out = lm_logits(ref, arch)
    for what in ("prefill", "forward", "decode", "decode_vs_forward"):
        assert_logits_close(out[what], f"{arch} {what}")
    assert out["max_expert_load"][0] == out["max_expert_load"][1]
    for k in ("moe_lb_loss", "moe_z_loss", "dropped_frac"):
        np.testing.assert_allclose(out[k][1], out[k][0], rtol=1e-6,
                                   err_msg=k)
