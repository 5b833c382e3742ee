"""The port's flash attention against the JAX package's, on the CPU.

The same numpy-seeded q, k and v go through the JAX package's Pallas
kernel (``flash_attention(..., interpret=True)``, padded to its 128-row
blocks), its oracle, and the port's wrapper, which on CPU tensors runs the
plain version through its own 64-row padding and ``kv_len`` mask.  All
float32; the kernel scales q before the product and the oracles divide the
scores, so they agree to rtol/atol 2e-5, not bit for bit.
"""

import numpy as np
import pytest
import torch

from _repro_reference import reference
from repro_torch.kernels.flash_attn.ops import KERNEL_TILE, flash_attention
from repro_torch.kernels.flash_attn.ref import flash_attention_ref

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _qkv(B, Sq, Skv, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, K, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, K, hd)).astype(np.float32))


CASES = [
    # B, Sq, Skv, H, K, hd, causal, window, softcap
    (1, 200, 200, 2, 2, 16, True, None, None),        # padding, G 1
    (1, 200, 200, 4, 2, 16, False, None, None),       # non-causal, G 2
    (1, 150, 150, 4, 1, 8, True, 40, None),           # window bites, G 4
    (2, 130, 130, 4, 1, 112, True, None, 50.0),       # softcap, hd 112, B 2
    (1, 100, 300, 8, 2, 8, False, None, 30.0),        # Sq < Skv, G 4
    (1, 300, 100, 2, 1, 16, True, None, None),        # Sq > Skv, causal
    (1, 260, 260, 4, 4, 8, False, 100, 50.0),         # window, non-causal
    (1, 70, 70, 4, 2, 112, True, 16, None),           # hd 112, window, G 2
]


@pytest.mark.parametrize("B,Sq,Skv,H,K,hd,causal,window,softcap", CASES)
def test_flash_matches_reference(ref, B, Sq, Skv, H, K, hd, causal, window,
                                 softcap):
    import jax.numpy as jnp
    q, k, v = _qkv(B, Sq, Skv, H, K, hd, seed=Sq + hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = np.asarray(ref.flash_ops.flash_attention(jq, jk, jv,
                                                      interpret=True, **kw))
    oracle = np.asarray(ref.flash_ref.flash_attention_ref(jq, jk, jv, **kw))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    port = flash_attention(tq, tk, tv, **kw)
    plain = flash_attention_ref(tq, tk, tv, **kw)
    assert port.shape == (B, Sq, H, hd) and port.dtype == torch.float32
    np.testing.assert_allclose(port.numpy(), pallas, **TOL)
    np.testing.assert_allclose(port.numpy(), oracle, **TOL)
    np.testing.assert_allclose(plain.numpy(), oracle, **TOL)


def test_kv_len_masks_padded_keys_exactly():
    """Keys padded with garbage and masked through ``kv_len`` leave the
    plain version where the unpadded call puts it (non-causal: the case
    the padding mask exists for)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 90, 90, 4, 2, 16, 3))
    junk = torch.full((1, 38, 2, 16), 7.0)
    kp, vp = torch.cat([k, junk], 1), torch.cat([v, junk], 1)
    a = flash_attention_ref(q, k, v, causal=False)
    b = flash_attention_ref(q, kp, vp, causal=False, kv_len=90)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-6)


def test_rows_sum_to_one():
    """v = 1 gives exactly 1 through the padding and the online-softmax
    bookkeeping."""
    q, k, _ = (torch.from_numpy(a) for a in _qkv(1, 100, 100, 4, 2, 16, 5))
    v = torch.ones_like(k)
    for causal, window in ((True, None), (False, None), (True, 7)):
        out = flash_attention(q, k, v, causal=causal, window=window)
        np.testing.assert_allclose(out.numpy(), 1.0, rtol=1e-6, atol=1e-6)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 3, 2, 16))
    with pytest.raises(ValueError):
        flash_attention(q, k, v)                      # H % K != 0
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 2, 300))
    with pytest.raises(ValueError):
        flash_attention(q, k, v)                      # hd beyond 256
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 8, 8, 2, 2, 16))
    with pytest.raises(TypeError):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError):
        flash_attention(q, k, v[:, :4])
    assert KERNEL_TILE == 64
    before = flash_attention.launches
    flash_attention(q, k, v)
    assert flash_attention.launches == before     # the CPU launches nothing
