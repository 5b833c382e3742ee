"""The port's kernel wrappers against the JAX package's, on the CPU.

On CPU tensors each wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernels in interpret mode, as its own tests do.  Inputs are
made with numpy from a seed and handed to both.  Tolerances: integer
counter products exact; float products rtol 1e-6 with an atol 1e-6 floor
for entries that cancel to near zero (contraction order differs).
"""

import numpy as np
import pytest
import torch

from _repro_reference import reference
from repro_torch.kernels.event_matmul import ops as em
from repro_torch.kernels.event_matmul.ref import event_matmul2_ref
from repro_torch.kernels.sigma_delta import ops as sd
from repro_torch.kernels.sigma_delta.ref import (window_cumsum_ref,
                                                 window_reconstruct_ref)

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _tiled(rng, shape, tile, tile_density, elem_density, scale=1.0):
    """Random float32 matrix whose (tile x tile) blocks are nonzero with
    probability ``tile_density`` and, inside a live block, elements with
    probability ``elem_density``."""
    nb = [-(-s // tile) for s in shape]
    live = rng.random(nb) < tile_density
    mask = np.kron(live, np.ones((tile, tile)))[:shape[0], :shape[1]]
    mask *= rng.random(shape) < elem_density
    return (rng.normal(0, scale, shape) * mask).astype(np.float32)


@pytest.mark.parametrize("act_d", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("w_d", [0.0, 0.4, 1.0])
@pytest.mark.parametrize("tile", [32, 128])
def test_event_matmul_pair_matches_reference(ref, act_d, w_d, tile):
    import jax.numpy as jnp
    rng = np.random.default_rng(int(act_d * 10 + w_d * 100 + tile))
    M, K, N = 200, 300, 260                       # ragged against every tile
    x = _tiled(rng, (M, K), tile, act_d, 0.4)
    m = (x != 0).astype(np.float32)
    w = _tiled(rng, (K, N), tile, w_d, 0.6, scale=1 / np.sqrt(K))
    wm = (w != 0).astype(np.float32)
    occ_r = ref.em_ops.weight_block_occupancy(jnp.asarray(w), tile, tile)
    occ_p = em.weight_block_occupancy(torch.from_numpy(w), tile, tile)
    assert np.array_equal(np.asarray(occ_r), occ_p.numpy())
    y_r, macs_r = ref.em_ops.event_matmul_pair(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(w), jnp.asarray(wm),
        occ_r, bm=tile, bk=tile, bn=tile)
    y_p, macs_p = em.event_matmul_pair(
        torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(w),
        torch.from_numpy(wm), occ_p, bm=tile, bk=tile, bn=tile)
    assert np.array_equal(np.asarray(macs_r), macs_p.numpy())
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **FLOAT_TOL)
    np.testing.assert_allclose(y_p.numpy(), x @ w, **FLOAT_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compaction_matches_reference(ref, seed):
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    active = rng.random((5, 7)) < 0.4
    active[1] = False                              # an all-dead m-block
    occ = rng.random((7, 4)) < 0.5
    occ[:, 2] = False                              # an all-dead n-block
    idx_r, cnt_r = ref.em_ops._compact_indices_joint(jnp.asarray(active),
                                                     jnp.asarray(occ))
    idx_p, cnt_p = em._compact_indices_joint(torch.from_numpy(active),
                                             torch.from_numpy(occ))
    assert np.array_equal(np.asarray(idx_r), idx_p.numpy())
    assert np.array_equal(np.asarray(cnt_r), cnt_p.numpy())
    assert idx_p.dtype == cnt_p.dtype == torch.int32
    x = rng.normal(0, 1, (70, 90)).astype(np.float32)
    x[:32] = 0.0
    xp_r, a_r, i_r, c_r = ref.em_ops.pad_compact(jnp.asarray(x), 0.0, 32,
                                                 32)
    xp_p, a_p, i_p, c_p = em.pad_compact(torch.from_numpy(x), 0.0, 32, 32)
    for r, p in ((xp_r, xp_p), (a_r, a_p), (i_r, i_p), (c_r, c_p)):
        assert np.array_equal(np.asarray(r), p.numpy())


def test_skipped_tiles_are_exact_zeros():
    """A (m, n) pair with cnt == 0 — dead activation row block or dead
    weight column block — is exactly zero, whatever the other operand."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (64, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (64, 64)).astype(np.float32))
    x[:32] = 0.0
    occ = em.weight_block_occupancy(w, 32, 32)
    occ[:, 1] = False                     # over-claimed dead n-block
    y = em.event_matmul2(x, w, occ, bm=32, bk=32, bn=32)
    assert bool((y[:32] == 0).all()) and bool((y[:, 32:] == 0).all())
    np.testing.assert_allclose(y[32:, :32].numpy(),
                               (x[32:] @ w[:, :32]).numpy(), **FLOAT_TOL)
    assert torch.equal(y, event_matmul2_ref(x, w, occ, threshold=0.0,
                                            bm=32, bk=32, bn=32))


@pytest.mark.parametrize("T,window", [(256, 32), (300, 32), (64, 8),
                                      (200, 128)])
def test_window_reconstruct_matches_reference(ref, T, window):
    import jax.numpy as jnp
    rng = np.random.default_rng(T + window)
    n = 96
    x = (rng.normal(0, 0.1, (T, n))
         * (rng.random((T, n)) < 0.2)).astype(np.float32)
    x[window:3 * window] = 0.0                     # quiet windows
    acc = rng.normal(0, 1, n).astype(np.float32)
    out_r = ref.sd_ops.window_reconstruct(jnp.asarray(x), jnp.asarray(acc),
                                          window=window)
    out_p = sd.window_reconstruct(torch.from_numpy(x), torch.from_numpy(acc),
                                  window=window)
    for r, p in zip(out_r, out_p):
        np.testing.assert_allclose(p.numpy(), np.asarray(r), **FLOAT_TOL)
    xwin = out_p[1]
    assert bool((xwin[window:3 * window] == 0).all())
    bases, _, new_acc = window_reconstruct_ref(torch.from_numpy(x),
                                               torch.from_numpy(acc),
                                               window=window)
    full = torch.from_numpy(acc) + torch.cumsum(torch.from_numpy(x), 0)
    recon = bases.repeat_interleave(window, 0)[:T] + xwin
    np.testing.assert_allclose(recon.numpy(), full.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(new_acc.numpy(), full[-1].numpy(), rtol=1e-5,
                               atol=1e-5)


def test_window_cumsum_quiet_flag_forces_zeros():
    x = torch.ones(16, 3)
    live = torch.tensor([1, 0], dtype=torch.int32)
    out = sd.window_cumsum(x, live, window=8)
    assert torch.equal(out[:8], torch.arange(1, 9.0)[:, None].expand(8, 3))
    assert bool((out[8:] == 0).all())
    assert torch.equal(out, window_cumsum_ref(x, live, window=8))


def test_wrappers_validate_and_count_only_launches():
    x = torch.ones(4, 8)
    w = torch.ones(8, 5)
    occ = em.weight_block_occupancy(w, 4, 4)
    before = (em.event_matmul2.launches, sd.window_cumsum.launches)
    em.event_matmul2(x, w, occ, bm=4, bk=4, bn=4)
    sd.window_cumsum(x, torch.ones(1, dtype=torch.int32), window=4)
    # the CPU path runs the plain version: no kernel launched
    assert (em.event_matmul2.launches, sd.window_cumsum.launches) == before
    with pytest.raises(ValueError):
        em.event_matmul2(x, w.T, occ, bm=4, bk=4, bn=4)
    with pytest.raises(ValueError):
        em.event_matmul2(x, w, occ[:1], bm=4, bk=4, bn=4)
    with pytest.raises(TypeError):
        em.event_matmul2(x.double(), w, occ, bm=4, bk=4, bn=4)
    with pytest.raises(ValueError):
        sd.window_cumsum(x, torch.ones(2, dtype=torch.int32), window=3)
    with pytest.raises(TypeError):
        sd.window_cumsum(x, torch.ones(1), window=4)
