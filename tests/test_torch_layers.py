"""The port's layers (``repro_torch.models.layers``) against the JAX
package's, on the CPU, from numpy seeds in float32: the norms and rotary
embedding, both attention cores, prefill and decode attention, the MLP,
the Mamba-2 SSD mixer and the RG-LRU mixer; then the logits of the two
recurrent archs' smoke configs (mamba2, recurrentgemma).

Tolerances, and why (every case float32):

* ``rms_norm``, ``rope``, ``softcap``: rtol 1e-6, atol ``ELT_ATOL``
  (one rounding apart: XLA's reciprocal, ``tanh`` and ``sin``/``cos``);
* attention, MLP and mixer outputs: rtol 1e-5, atol ``OUT_ATOL``
  (float32 sums in another order);
* ``_sdpa`` against ``_chunked_sdpa`` in the port: the same (one softmax
  pass against the online one);
* ``rglru_mixer``'s prefill: the port scans in ceil(log2 S) doubling
  steps where the reference's ``associative_scan`` combines in another
  tree order, so the float32 products and sums of the recurrence differ
  in order; rtol 1e-5, atol ``SCAN_ATOL`` (measured below 1e-6);
* logits: ``_torch_models.LOGIT_RTOL`` / ``LOGIT_ATOL``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _repro_reference import reference
from _torch_models import assert_logits_close, lm_logits, np_, port_cfg
from repro_torch.models import layers as L
from repro_torch.models.common import BlockCfg

ELT_ATOL = 1e-6
OUT_ATOL = 1e-5
SCAN_ATOL = 1e-5
RECURRENT_ARCHS = ["mamba2-1.3b", "recurrentgemma-2b"]


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=OUT_ATOL, rtol=1e-5, what=""):
    np.testing.assert_allclose(np_(got), np_(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _module(kind, tree, *args):
    m = kind(*args, torch.float32, "cpu")
    L.load_tree(m, jax.tree.map(np.asarray, tree))
    return m


def _smoke(ref, arch, **changes):
    cfg = ref.registry.get(arch).smoke()
    return dataclasses.replace(cfg, **changes) if changes else cfg


def test_norm_rope_softcap(ref):
    rng = np.random.default_rng(0)
    x, g = _rand(rng, 2, 7, 4, 16), _rand(rng, 16, scale=0.1)
    _close(L.rms_norm(_t(x), _t(g), 1e-6), ref.layers.rms_norm(x, g, 1e-6),
           ELT_ATOL, 1e-6)
    pos = np.arange(3, 10)
    _close(L.rope(_t(x), _t(pos), 1e4), ref.layers.rope(x, pos, 1e4),
           ELT_ATOL, 1e-6)
    pos2 = rng.integers(0, 4096, (2, 7))
    _close(L.rope(_t(x), _t(pos2), 1e6), ref.layers.rope(x, pos2, 1e6),
           ELT_ATOL * 4, 1e-6)
    s = _rand(rng, 3, 50, scale=40.0)
    _close(L.softcap(_t(s), 30.0), ref.layers.softcap(s, 30.0), ELT_ATOL * 30,
           1e-6)
    st = _t(s)
    assert L.softcap(st, None) is st


def test_sdpa_and_chunked_sdpa_agree(ref):
    """Skv = 2048 with 1024-key chunks: both cores, windowed with a
    softcap, in the port and against the reference's chunked core."""
    cfg = _smoke(ref, "gemma2-2b")
    rng = np.random.default_rng(1)
    B, S, H, K, hd = 1, 2048, 4, 2, 16
    q, k, v = (_rand(rng, B, S, n, hd) for n in (H, K, K))
    pos = np.arange(S)
    for window in (None, 700):
        bias = L._mask_bias(_t(pos), _t(pos), window)
        one = L._sdpa(_t(q), _t(k), _t(v), bias, cfg)
        chunked = L._chunked_sdpa(_t(q), _t(k), _t(v), _t(pos), _t(pos),
                                  window, cfg, kv_chunk=1024)
        _close(chunked, one, what=f"port chunked vs one pass, {window}")
        want = ref.layers._chunked_sdpa(q, k, v, pos, pos, window, cfg,
                                        kv_chunk=1024)
        _close(chunked, want, what=f"chunked vs reference, {window}")
    nc = L._chunked_sdpa(_t(q), _t(k), _t(v), _t(pos), _t(pos), None, cfg,
                         kv_chunk=1024, causal=False)
    _close(nc, ref.layers._chunked_sdpa(q, k, v, pos, pos, None, cfg,
                                        kv_chunk=1024, causal=False))


@pytest.mark.parametrize("window", [None, 5])
def test_attention_prefill_and_decode(ref, window):
    """``attention`` (with ``return_kv``) and ``attention_decode`` on a
    ring (window 5) or linear cache, GQA with qk-norm and a softcap."""
    cfg = _smoke(ref, "olmoe-1b-7b", n_kv_heads=2, attn_softcap=20.0)
    blk = BlockCfg(kind="attn", window=window)
    ctx = ref.layers.ShardCtx()
    params = ref.layers.attn_params(ref.layers.KeyGen(
        jax.random.PRNGKey(4)), cfg, jnp.float32)
    params = {**params, "q_gamma": jnp.full((16,), 0.1),
              "k_gamma": jnp.full((16,), -0.2)}
    pcfg = port_cfg(cfg)
    p = _module(L.Attention, params, pcfg)
    rng = np.random.default_rng(2)
    S = 9
    x = _rand(rng, 2, S, cfg.d_model)
    pos = np.arange(S)
    want_y, (wk, wv) = ref.layers.attention(
        x, params, blk, cfg, ctx, positions=jnp.asarray(pos), return_kv=True)
    got_y, (gk, gv) = L.attention(_t(x), p, blk, pcfg, positions=_t(pos),
                                  return_kv=True)
    _close(got_y, want_y, what="prefill")
    _close(gk, wk, what="k")
    _close(gv, wv, what="v")

    # decode position S against a cache holding positions < S
    W = window or S + 3
    idx = np.arange(S - min(S, W), S)
    ck = np.zeros((2, W) + wk.shape[2:], np.float32)
    cv = np.zeros_like(ck)
    ck[:, idx % W] = np.asarray(wk)[:, -len(idx):]
    cv[:, idx % W] = np.asarray(wv)[:, -len(idx):]
    xd = _rand(rng, 2, 1, cfg.d_model)
    want = ref.layers.attention_decode(
        xd, params, blk, cfg, ctx, cache_k=jnp.asarray(ck),
        cache_v=jnp.asarray(cv), pos=jnp.int32(S))
    got = L.attention_decode(_t(xd), p, blk, pcfg, cache_k=_t(ck),
                             cache_v=_t(cv), pos=S)
    for g, w, what in zip(got, want, ("y", "cache_k", "cache_v")):
        _close(g, w, what=f"decode {what}")
    # cross-attention: every slot valid, no rope, the cache untouched
    want = ref.layers.attention_decode(
        xd, params, blk, cfg, ctx, cache_k=jnp.asarray(ck),
        cache_v=jnp.asarray(cv), pos=jnp.int32(0), cross=True)
    got = L.attention_decode(_t(xd), p, blk, pcfg, cache_k=_t(ck),
                             cache_v=_t(cv), pos=0, cross=True)
    _close(got[0], want[0], what="cross decode")
    _close(got[1], ck, what="cross cache untouched")


def test_mlp(ref):
    cfg = _smoke(ref, "gemma2-2b")
    params = ref.layers.mlp_params(ref.layers.KeyGen(jax.random.PRNGKey(5)),
                                   cfg.d_model, 96, jnp.float32)
    p = _module(L.MLP, params, cfg.d_model, 96)
    x = _rand(np.random.default_rng(3), 2, 5, cfg.d_model)
    for act in ("gelu", "silu", "relu"):
        c = dataclasses.replace(cfg, act_fn=act)
        _close(L.mlp(_t(x), p, port_cfg(c)),
               ref.layers.mlp(x, params, c, ref.layers.ShardCtx()), what=act)


def _ssd(ref, seed=6):
    cfg = _smoke(ref, "mamba2-1.3b")
    s = dataclasses.replace(cfg.pattern[0].ssd, n_groups=2)
    params = ref.layers.ssd_params(ref.layers.KeyGen(jax.random.PRNGKey(seed)),
                                   cfg, s, jnp.float32)
    rng = np.random.default_rng(seed)
    params = {**params, "A_log": jnp.asarray(_rand(rng, 4, scale=0.5)),
              "dt_bias": jnp.asarray(_rand(rng, 4, scale=0.5)),
              "norm_g": jnp.asarray(_rand(rng, s.d_inner, scale=0.1))}
    pcfg = port_cfg(cfg)
    return cfg, s, params, pcfg, _module(L.SSD, params, pcfg, port_cfg(s))


@pytest.mark.parametrize("S", [24, 13])
def test_ssd_mixer_prefill_and_decode(ref, S):
    """S = 24: three chunks of 8; S = 13 (prime): chunks of 1.  Then one
    decode step from the prefill's conv and SSM states."""
    cfg, s, params, pcfg, p = _ssd(ref)
    ctx = ref.layers.ShardCtx()
    rng = np.random.default_rng(S)
    x = _rand(rng, 2, S, cfg.d_model)
    want = ref.layers.ssd_mixer(x, params, s, cfg, ctx)
    got = L.ssd_mixer(_t(x), p, port_cfg(s), pcfg)
    for g, w, what in zip(got, want, ("y", "conv", "state")):
        _close(g, w, what=f"prefill {what}")
    xd = _rand(rng, 2, 1, cfg.d_model)
    want = ref.layers.ssd_mixer(xd, params, s, cfg, ctx, conv_state=want[1],
                                ssm_state=want[2], decode=True)
    got = L.ssd_mixer(_t(xd), p, port_cfg(s), pcfg, conv_state=got[1],
                      ssm_state=got[2], decode=True)
    for g, w, what in zip(got, want, ("y", "conv", "state")):
        _close(g, w, what=f"decode {what}")


@pytest.mark.parametrize("S,chunk", [(24, 8), (24, 6), (13, 1)])
def test_ssd_chunk_scan(ref, S, chunk):
    rng = np.random.default_rng(S + chunk)
    xh = _rand(rng, 2, S, 4, 8)
    a = -np.abs(_rand(rng, 2, S, 4, scale=0.3))
    Bm, Cm = _rand(rng, 2, S, 2, 5), _rand(rng, 2, S, 2, 5)
    s0 = _rand(rng, 2, 4, 8, 5)
    for init in (None, s0):
        want = ref.layers._ssd_chunk_scan(xh, a, Bm, Cm, chunk,
                                          init_state=init)
        got = L._ssd_chunk_scan(_t(xh), _t(a), _t(Bm), _t(Cm), chunk,
                                init_state=None if init is None else _t(init))
        _close(got[0], want[0], what="y")
        _close(got[1], want[1], what="final state")


@pytest.mark.parametrize("S", [1, 7, 16, 33])
def test_rglru_mixer_prefill_and_decode(ref, S):
    cfg = _smoke(ref, "recurrentgemma-2b")
    r = cfg.prefix[0].rglru
    params = ref.layers.rglru_params(ref.layers.KeyGen(jax.random.PRNGKey(7)),
                                     cfg, r, jnp.float32)
    pcfg = port_cfg(cfg)
    p = _module(L.RGLRU, params, pcfg, port_cfg(r))
    ctx = ref.layers.ShardCtx()
    rng = np.random.default_rng(S)
    x = _rand(rng, 2, S, cfg.d_model)
    h0 = _rand(rng, 2, r.d_rnn)
    for h_state in (None, h0):
        want = ref.layers.rglru_mixer(x, params, r, cfg, ctx, h_state=h_state)
        got = L.rglru_mixer(_t(x), p, port_cfg(r), pcfg,
                            h_state=None if h_state is None else _t(h0))
        for g, w, what in zip(got, want, ("y", "conv", "h")):
            _close(g, w, atol=SCAN_ATOL, what=f"prefill {what}")
    xd = _rand(rng, 2, 1, cfg.d_model)
    want = ref.layers.rglru_mixer(xd, params, r, cfg, ctx,
                                  conv_state=want[1], h_state=want[2],
                                  decode=True)
    got = L.rglru_mixer(_t(xd), p, port_cfg(r), pcfg, conv_state=got[1],
                        h_state=got[2], decode=True)
    for g, w, what in zip(got, want, ("y", "conv", "h")):
        _close(g, w, atol=SCAN_ATOL, what=f"decode {what}")


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_recurrent_archs_match_reference(ref, arch):
    out = lm_logits(ref, arch)
    for what in ("prefill", "forward", "decode", "decode_vs_forward"):
        assert_logits_close(out[what], f"{arch} {what}")
