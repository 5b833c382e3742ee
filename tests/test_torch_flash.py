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
from repro_torch.kernels import build
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
    (1, 300, 300, 4, 2, 36, False, None, None),       # hd 36, ragged, G 2
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


# ------------------------------------------- the CUDA kernel's arithmetic
# The kernel (csrc/flash_attn.cu) runs only on the card; these tests hold
# the two choices its accuracy and its register layout rest on, on the CPU.

def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on an int32 view: add half a TF32 ulp to the
    magnitude bits and clear the 13 bits below TF32's 10-bit mantissa."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _tf32x1(a, b):
    return _tf32_rna(a) @ _tf32_rna(b)


def _tf32x3(a, b):
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tile_attention(q, k, v, product, bk=64):
    """One 64-row q tile (pre-scaled) over k, v as the kernel walks it:
    64-key tiles, online softmax in float32, a fresh P.V partial per tile
    joined as acc * alpha + partial."""
    m = torch.full((q.shape[0], 1), -1e30)
    l = torch.zeros((q.shape[0], 1))
    acc = torch.zeros((q.shape[0], v.shape[1]))
    for k0 in range(0, k.shape[0], bk):
        s = product(q, k[k0:k0 + bk].T)
        m_new = torch.maximum(m, s.amax(1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(1, keepdim=True)
        acc = acc * alpha + product(p, v[k0:k0 + bk])
        m = m_new
    return acc / l


def test_tf32_rna_emulation_rounds_half_away_from_zero():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2),
                      1 + one_ulp / 2 - 2.0 ** -20, 3.0], dtype=torch.float32)
    assert _tf32_rna(x).tolist() == [1 + one_ulp, -(1 + one_ulp), 1.0, 3.0]


def test_3xtf32_keeps_peaked_scores_where_one_pass_tf32_does_not():
    """Why the kernel is 3xTF32: at whisper's encoder shape (1500 keys,
    hd 64) with q x 4 (scores of std 4, as trained attention has, no cap),
    one-pass TF32 misses the float32 oracle by more than the frontend's
    2e-4 probe limit, while 3xTF32 stays within 1e-5."""
    rng = np.random.default_rng(7)
    hd = 64
    q = torch.from_numpy((4.0 * rng.standard_normal((64, hd)))
                         .astype(np.float32)) / np.float32(np.sqrt(hd))
    k = torch.from_numpy(rng.standard_normal((1500, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1500, hd)).astype(np.float32))
    oracle = torch.softmax(q @ k.T, dim=-1) @ v
    err3 = (_tile_attention(q, k, v, _tf32x3) - oracle).abs().max().item()
    err1 = (_tile_attention(q, k, v, _tf32x1) - oracle).abs().max().item()
    assert err3 <= 1e-5, err3
    assert err1 > 2e-4, err1


def _lanes():
    lane = torch.arange(32)
    return lane // 4, lane % 4                    # g, t


def _mma(a, b):
    """mma.sync.m16n8k8 by its fragment layout: a (32, 4) and b (32, 2)
    registers per lane; returns the (32, 4) accumulator registers."""
    g, t = _lanes()
    A = torch.zeros(16, 8, dtype=a.dtype)
    B = torch.zeros(8, 8, dtype=b.dtype)
    A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = a.unbind(1)
    B[t, g], B[t + 4, g] = b.unbind(1)
    D = A @ B
    return torch.stack([D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t],
                        D[g + 8, 2 * t + 1]], 1)


def _acc(M):
    """A 16 x 8 matrix as accumulator registers."""
    g, t = _lanes()
    return torch.stack([M[g, 2 * t], M[g, 2 * t + 1], M[g + 8, 2 * t],
                        M[g + 8, 2 * t + 1]], 1)


def test_p_stays_in_registers_through_the_key_permutation():
    """P.V's k step reads its A fragment straight from the score
    accumulator, a = {c0, c2, c1, c3} (A column t <-> key 2t, t + 4 <->
    key 2t + 1), and its B fragment from V rows 2t and 2t + 1: the same
    product as the unpermuted one, exactly (integer-valued, float64)."""
    gen = torch.Generator().manual_seed(3)
    g, t = _lanes()
    for _ in range(4):
        P = torch.randint(-50, 50, (16, 8), generator=gen).double()
        V = torch.randint(-50, 50, (8, 8), generator=gen).double()
        c = _acc(P)
        a = c[:, [0, 2, 1, 3]]
        b = torch.stack([V[2 * t, g], V[2 * t + 1, g]], 1)
        assert torch.equal(_mma(a, b), _acc(P @ V))


def test_kernel_operand_maps_reproduce_both_products():
    """The kernel's other two register maps, exactly: Q.K^T reads one
    float4 per row for a pair of k steps (columns 16kp + 4t .. + 3 hold A/B
    columns t, t + 4 of step 0, then of step 1), and P.V's output slice
    4G + u reads V column 32G + 4g + u, so accumulator (c0, c1) of slice
    4G + u is output column 32G + 8t + u (+ 4)."""
    gen = torch.Generator().manual_seed(5)
    g, t = _lanes()
    Q = torch.randint(-50, 50, (16, 32), generator=gen).double()
    Kt = torch.randint(-50, 50, (8, 32), generator=gen).double()  # keys x hd
    s = torch.zeros(32, 4, dtype=torch.float64)
    for kp in range(2):
        x = Q[g[:, None], 16 * kp + 4 * t[:, None] + torch.arange(4)]       # rows g
        y = Q[g[:, None] + 8, 16 * kp + 4 * t[:, None] + torch.arange(4)]   # g + 8
        kx = Kt[g[:, None], 16 * kp + 4 * t[:, None] + torch.arange(4)]
        for step in range(2):
            a = torch.stack([x[:, 2 * step], y[:, 2 * step],
                             x[:, 2 * step + 1], y[:, 2 * step + 1]], 1)
            s += _mma(a, kx[:, 2 * step:2 * step + 2])
    assert torch.equal(s, _acc(Q @ Kt.T))

    P = torch.randint(-50, 50, (16, 8), generator=gen).double()
    V = torch.randint(-50, 50, (8, 64), generator=gen).double()
    a = _acc(P)[:, [0, 2, 1, 3]]
    out = torch.zeros(16, 64, dtype=torch.float64)
    for G in range(2):
        for u in range(4):
            col = 32 * G + 4 * g + u
            d = _mma(a, torch.stack([V[2 * t, col], V[2 * t + 1, col]], 1))
            for e, (dr, dc) in enumerate(((0, 0), (0, 4), (8, 0), (8, 4))):
                out[g + dr, 32 * G + 8 * t + dc + u] = d[:, e]
    assert torch.equal(out, P @ V)


def test_library_name_hashes_the_headers(tmp_path, monkeypatch):
    """An edited header is never served from a stale build: the library's
    name hashes ``csrc/*.cuh`` too, while nvcc compiles only ``*.cu``."""
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert build.sources() == [tmp_path / "a.cu"]
    before = build.library_path()
    (tmp_path / "h.cuh").write_text("// two\n")
    assert build.library_path() != before
