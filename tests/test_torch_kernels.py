"""The port's kernel wrappers against the JAX package's, on the CPU.

On CPU tensors each wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernels in interpret mode, as its own tests do.  Inputs are
made with numpy from a seed and handed to both.  Tolerances: integer
counter products and the sigma-delta encoder exact; float32 products rtol
1e-6 with an atol floor (1e-6 for the joint kernel's operands, 1e-5 for
the 1-D kernel's unit-normal ones) for entries that cancel to near zero
(contraction order differs); bfloat16 products 2e-2, the reference's own
tolerance for them.  Weights are scaled by 1 / sqrt(K), as the network
builders draw them, so outputs are of order one and the atol floor is
relative to them.
"""

import numpy as np
import pytest
import torch

from _repro_reference import reference
import repro_torch.kernels
from repro_torch.kernels.event_matmul import ops as em
from repro_torch.kernels.event_matmul.ref import (event_matmul2_ref,
                                                  event_matmul_ref,
                                                  event_stats_ref,
                                                  live_lists_ref,
                                                  split_bounds_ref,
                                                  zero_dead_tiles_ref)
from repro_torch.kernels.sigma_delta import ops as sd
from repro_torch.kernels.sigma_delta.ref import (sigma_delta_ref,
                                                 window_cumsum_ref,
                                                 window_reconstruct_ref)

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)
EM_TOL = {"float32": dict(rtol=1e-6, atol=1e-5),
          "bfloat16": dict(rtol=2e-2, atol=2e-2)}


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


# ------------------------------------------- the 1-D kernel's public API


def _block_sparse(rng, m, k, density, bm, bk):
    """float32 activations with a controlled fraction of live (bm, bk)
    tiles (the reference test sweep's generator)."""
    x = rng.normal(size=(m, k)).astype(np.float32)
    keep = rng.random((-(-m // bm), -(-k // bk))) < density
    return x * np.repeat(np.repeat(keep, bm, 0), bk, 1)[:m, :k]


def _both(a: np.ndarray, dtype: str):
    """The same numbers as a jax array and a torch tensor of ``dtype``."""
    import jax.numpy as jnp
    return (jnp.asarray(a, getattr(jnp, dtype)),
            torch.from_numpy(a).to(getattr(torch, dtype)))


def _np(a) -> np.ndarray:
    """float32 numpy view of a jax array or torch tensor (bf16 widened)."""
    if isinstance(a, torch.Tensor):
        return a.to(torch.float32).numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("M,K,N", [(128, 128, 128), (256, 512, 256),
                                   (384, 256, 640), (130, 257, 100),
                                   (8, 1024, 128), (1, 128, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_event_matmul_1d_matches_reference(ref, M, K, N, dtype):
    rng = np.random.default_rng(M * 7 + K + N)
    x_r, x_p = _both(_block_sparse(rng, M, K, 0.5, 128, 128), dtype)
    w_r, w_p = _both(rng.normal(0, 1 / np.sqrt(K), (K, N))
                     .astype(np.float32), dtype)
    y_r = ref.em_ops.event_matmul(x_r, w_r, threshold=0.0)
    y_p = repro_torch.kernels.event_matmul(x_p, w_p, threshold=0.0)
    assert y_p.dtype == x_p.dtype and tuple(y_p.shape) == (M, N)
    np.testing.assert_allclose(_np(y_p), _np(y_r), **EM_TOL[dtype])
    xp = em._pad_to(x_p, (128, 128))
    wp = em._pad_to(w_p, (128, 128))
    assert torch.equal(y_p, event_matmul_ref(xp, wp, threshold=0.0, bm=128,
                                             bk=128)[:M, :N])


@pytest.mark.parametrize("blocks", [(128, 128, 128), (256, 128, 256),
                                    (8, 128, 128)])
def test_event_matmul_block_sizes_match_reference(ref, blocks):
    import jax.numpy as jnp
    bm, bk, bn = blocks
    rng = np.random.default_rng(3)
    x = _block_sparse(rng, 2 * bm, 4 * bk, 0.4, bm, bk)
    w = rng.normal(0, 1 / np.sqrt(4 * bk), (4 * bk, 2 * bn)) \
        .astype(np.float32)
    y_r = ref.em_ops.event_matmul(jnp.asarray(x), jnp.asarray(w),
                                  threshold=0.0, bm=bm, bk=bk, bn=bn)
    y_p = em.event_matmul(torch.from_numpy(x), torch.from_numpy(w),
                          threshold=0.0, bm=bm, bk=bk, bn=bn)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r),
                               **EM_TOL["float32"])
    y_rr = ref.em_ref.event_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                       threshold=0.0, bm=bm, bk=bk)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_rr),
                               **EM_TOL["float32"])


def test_event_matmul_threshold_and_dense_cases(ref):
    import jax.numpy as jnp
    rng = np.random.default_rng(5)
    small = (rng.normal(size=(128, 256)) * 0.01).astype(np.float32)
    w = rng.normal(size=(256, 128)).astype(np.float32)
    y = em.event_matmul(torch.from_numpy(small), torch.from_numpy(w),
                        threshold=1.0)            # everything sub-threshold
    assert bool((y == 0).all())
    # one entry above the threshold keeps its whole (bm, bk) tile, the
    # sub-threshold entries included: block granularity
    small[3, 200] = 2.0
    y = em.event_matmul(torch.from_numpy(small), torch.from_numpy(w),
                        threshold=1.0)
    y_r = ref.em_ops.event_matmul(jnp.asarray(small), jnp.asarray(w),
                                  threshold=1.0)
    kept = small.copy()
    kept[:, :128] = 0.0
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **FLOAT_TOL)
    np.testing.assert_allclose(y.numpy(), kept @ w, **FLOAT_TOL)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(256, 384)).astype(np.float32)
    w = rng.normal(0, 1 / np.sqrt(384), (384, 256)).astype(np.float32)
    y = em.event_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(y.numpy(), x @ w, **EM_TOL["float32"])
    with pytest.raises(ValueError):
        em.event_matmul(torch.zeros(8, 16), torch.zeros(32, 8))


@pytest.mark.parametrize("act_d", [0.1, 0.5, 1.0])
def test_event_matmul_pair_without_occupancy_matches_reference(ref, act_d):
    """Without ``w_occ`` both products go through the 1-D kernel; the
    counter product stays bit-identical to the dense ``m @ wm``."""
    import jax.numpy as jnp
    rng = np.random.default_rng(int(act_d * 10))
    M, K, N = 200, 300, 260
    x = _tiled(rng, (M, K), 128, act_d, 0.4)
    m = (x != 0).astype(np.float32)
    w = _tiled(rng, (K, N), 128, 0.7, 0.6, scale=1 / np.sqrt(K))
    wm = (w != 0).astype(np.float32)
    y_r, macs_r = ref.em_ops.event_matmul_pair(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(w), jnp.asarray(wm))
    before = em.event_matmul.launches
    y_p, macs_p = em.event_matmul_pair(
        torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(w),
        torch.from_numpy(wm))
    assert em.event_matmul.launches == before      # plain version on CPU
    assert np.array_equal(macs_p.numpy(), np.asarray(macs_r))
    assert np.array_equal(macs_p.numpy(), m @ wm)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **FLOAT_TOL)
    # with an all-ones occupancy the joint kernel computes the same pair
    ones = torch.ones((3, 3), dtype=torch.bool)
    y2, macs2 = em.event_matmul_pair(
        torch.from_numpy(x), torch.from_numpy(m), torch.from_numpy(w),
        torch.from_numpy(wm), ones)
    assert torch.equal(macs2, macs_p)
    np.testing.assert_allclose(y2.numpy(), y_p.numpy(), **FLOAT_TOL)


def test_block_activity_and_stats_match_reference(ref):
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    x = _block_sparse(rng, 256, 512, 0.25, 128, 128)
    act_r = ref.em_ops.block_activity(jnp.asarray(x), 0.0)
    act_p = repro_torch.kernels.block_activity(torch.from_numpy(x), 0.0)
    assert np.array_equal(np.asarray(act_r), act_p.numpy())
    ragged = x[:130, :200]
    assert np.array_equal(
        np.asarray(ref.em_ops.block_activity(jnp.asarray(ragged), 0.0,
                                             128, 64)),
        em.block_activity(torch.from_numpy(ragged), 0.0, 128, 64).numpy())
    st_r = ref.em_ref.event_stats_ref(jnp.asarray(x), 0.0, 128, 128)
    st_p = event_stats_ref(torch.from_numpy(x), 0.0, 128, 128)
    assert int(st_p["active_blocks"]) == int(st_r["active_blocks"]) \
        == int(act_p.sum())
    assert st_p["total_blocks"] == int(st_r["total_blocks"])
    for key in ("block_density", "element_density",
                "skipped_weight_bytes_frac"):
        np.testing.assert_allclose(float(st_p[key]), float(st_r[key]),
                                   rtol=1e-6)


def test_public_kernel_api_matches_reference(ref):
    import repro.kernels
    assert repro_torch.kernels.__all__ == repro.kernels.__all__
    for name in repro_torch.kernels.__all__:
        assert callable(getattr(repro_torch.kernels, name)), name


#: the JAX package's device-search engine names, lazy in both packages
DEVICE_SEARCH = ("DeviceSearchEngine", "evolutionary_search_device",
                 "generation_draws", "mutate_rows_array",
                 "survival_order_array")


def test_core_exports_match_reference(ref):
    import repro.core
    import repro_torch.core
    assert sorted(repro_torch.core.__all__) == sorted(repro.core.__all__)
    for name in repro_torch.core.__all__:      # eager and lazy alike
        obj = getattr(repro_torch.core, name)
        assert obj.__module__.startswith("repro_torch.") \
            or name == "Evaluator", name
    for name in DEVICE_SEARCH:
        assert getattr(repro_torch.core, name).__module__ \
            == "repro_torch.core.device_search"
    with pytest.raises(AttributeError):
        getattr(repro_torch.core, "evolutionary_search_vmap")


def test_neuromorphic_exports_cover_reference(ref):
    import repro.neuromorphic
    import repro_torch.neuromorphic
    from repro_torch.neuromorphic.timestep import LayerStageTimes
    assert repro_torch.neuromorphic.LayerStageTimes is LayerStageTimes
    assert repro_torch.neuromorphic.device_pricer.__module__ \
        == "repro_torch.neuromorphic.timestep"
    # every name, the vmap pricer's and DevicePopulationPricer included
    assert set(repro.neuromorphic.__all__) \
        <= set(repro_torch.neuromorphic.__all__)
    for name in repro_torch.neuromorphic.__all__:
        getattr(repro_torch.neuromorphic, name)


# ------------------------------- the tensor-core tile body's host contract


@pytest.mark.parametrize("act_d", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("w_d", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("tile", [32, 128])
def test_int8_counter_route_matches_reference(ref, act_d, w_d, tile):
    """Counters through int8 0/1 masks (the kernel's int8 instance on the
    card) equal the reference's ``event_matmul_pair`` counters bit for
    bit, in float32; at 128-wide tiles also through the event backend's
    prepared weights."""
    import jax.numpy as jnp
    rng = np.random.default_rng(int(act_d * 10 + w_d * 100 + tile) + 7)
    M, K, N = 200, 300, 260
    x = _tiled(rng, (M, K), tile, act_d, 0.4)
    m = (x != 0).astype(np.float32)
    w = _tiled(rng, (K, N), tile, w_d, 0.6, scale=1 / np.sqrt(K))
    wm = (w != 0).astype(np.float32)
    occ_r = ref.em_ops.weight_block_occupancy(jnp.asarray(w), tile, tile)
    _, macs_r = ref.em_ops.event_matmul_pair(
        jnp.asarray(x), jnp.asarray(m), jnp.asarray(w), jnp.asarray(wm),
        occ_r, bm=tile, bk=tile, bn=tile)
    m8 = torch.from_numpy(m).to(torch.int8)
    wm8 = torch.from_numpy(wm).to(torch.int8)
    occ = torch.from_numpy(np.array(occ_r))
    _, macs_p = em.event_matmul_pair(torch.from_numpy(x), m8,
                                     torch.from_numpy(w), wm8, occ,
                                     bm=tile, bk=tile, bn=tile)
    assert macs_p.dtype == torch.float32
    assert np.array_equal(macs_p.numpy(), np.asarray(macs_r))
    assert np.array_equal(macs_p.numpy(), m @ wm)
    if tile == 128:
        for kw in (em.KernelWeights(wm8, occ), em.KernelWeights(wm8)):
            macs_k = em.event_matmul_packed(m8, kw)
            assert np.array_equal(macs_k.numpy(), np.asarray(macs_r))


@pytest.mark.parametrize("w_d", [0.3, 1.0])
@pytest.mark.parametrize("M,K,N", [(256, 384, 256), (200, 300, 260)])
def test_event_matmul2_bf16_matches_pallas(ref, w_d, M, K, N):
    """The joint product in bfloat16 (new on the card) against the
    reference's joint Pallas kernel in bfloat16, at its 2e-2."""
    import jax.numpy as jnp
    rng = np.random.default_rng(int(w_d * 10) + M)
    x = _tiled(rng, (M, K), 128, 0.6, 0.5)
    w = _tiled(rng, (K, N), 128, w_d, 0.6, scale=1 / np.sqrt(K))
    x_r, x_p = _both(x, "bfloat16")
    w_r, w_p = _both(w, "bfloat16")
    occ_r = ref.em_ops.weight_block_occupancy(w_r)
    xp_r, active, _, _ = ref.em_ops.pad_compact(x_r, 0.0)
    idx, cnt = ref.em_ops._compact_indices_joint(active, occ_r)
    y_r = ref.em_ops.event_matmul2_pallas(
        xp_r, ref.em_ops._pad_to(w_r, (128, 128)), idx, cnt, bm=128,
        bk=128, bn=128, interpret=True)[:M, :N]
    y_p = em.event_matmul2(x_p, w_p, torch.from_numpy(np.array(occ_r)))
    assert y_p.dtype == torch.bfloat16 and tuple(y_p.shape) == (M, N)
    np.testing.assert_allclose(_np(y_p), _np(y_r), **EM_TOL["bfloat16"])
    y_k = em.event_matmul_packed(x_p, em.KernelWeights(
        w_p, torch.from_numpy(np.array(occ_r))))
    assert torch.equal(y_k, y_p)


@pytest.mark.parametrize("mb,kb,nb", [(5, 7, 4), (3, 70, 5), (1, 1, 1),
                                      (4, 33, 2)])
def test_live_lists_match_compaction(ref, mb, kb, nb):
    """The plain model of the in-block live list (ballot and popcount
    prefix, 32 k tiles at a time) equals the host compaction and the
    reference's, cnt == 0 pairs and ragged Kb included; the split bounds
    cover each list once, in order."""
    import jax.numpy as jnp
    rng = np.random.default_rng(mb * 100 + kb)
    active = rng.random((mb, kb)) < 0.4
    active[0] = False                              # an all-dead m-block
    occ = rng.random((kb, nb)) < 0.5
    occ[:, -1] = False                             # an all-dead n-block
    idx, cnt = live_lists_ref(torch.from_numpy(active),
                              torch.from_numpy(occ))
    idx_h, cnt_h = em._compact_indices_joint(torch.from_numpy(active),
                                             torch.from_numpy(occ))
    idx_r, cnt_r = ref.em_ops._compact_indices_joint(jnp.asarray(active),
                                                     jnp.asarray(occ))
    assert torch.equal(idx, idx_h) and torch.equal(cnt, cnt_h)
    assert np.array_equal(idx.numpy(), np.asarray(idx_r))
    assert np.array_equal(cnt.numpy(), np.asarray(cnt_r))
    assert int((cnt == 0).sum()) >= mb
    idx1, cnt1 = live_lists_ref(torch.from_numpy(active))
    idx1_r, cnt1_r = ref.em_ops._compact_indices(jnp.asarray(active))
    assert idx1.shape == (mb, 1, kb)
    assert np.array_equal(idx1[:, 0].numpy(), np.asarray(idx1_r))
    assert np.array_equal(cnt1[:, 0].numpy(), np.asarray(cnt1_r))
    for splits in (1, 3, 8):
        lo, hi = split_bounds_ref(cnt, splits)
        assert torch.equal(lo[0], torch.zeros_like(lo[0]))
        assert torch.equal(hi[-1], cnt.to(torch.int64))
        assert torch.equal(lo[1:], hi[:-1]) and bool((hi >= lo).all())


@pytest.mark.parametrize("bm", [8, 32, 64])
def test_masked_x_route_matches_reference(ref, bm):
    """Tiles other than the kernel's 128: zero the event-free (bm, 128)
    tiles of x, then the 128-tile product at threshold 0, as the CUDA
    wrappers do; with a threshold above 0 it equals the reference's
    (bm, 128) product and the port's own (bm, 128) plain version."""
    import jax.numpy as jnp
    rng = np.random.default_rng(bm)
    M, K, N = 200, 300, 140
    x = (rng.normal(size=(M, K)) * 0.05).astype(np.float32)
    for i, j in zip(*np.nonzero(rng.random((-(-M // bm), -(-K // 128)))
                                < 0.4)):          # one event per live tile
        r, c = i * bm + rng.integers(bm), j * 128 + rng.integers(128)
        x[min(r, M - 1), min(c, K - 1)] = 2.0
    w = rng.normal(0, 1 / np.sqrt(K), (K, N)).astype(np.float32)
    thr = 0.5
    xm = zero_dead_tiles_ref(torch.from_numpy(x), thr, bm, 128)
    assert xm.shape == (M, K)
    live = em.block_activity(torch.from_numpy(x), thr, bm, 128)
    assert 0 < int(live.sum()) < live.numel()
    y_p = event_matmul_ref(em._pad_to(xm, (128, 128)),
                           em._pad_to(torch.from_numpy(w), (128, 128)),
                           threshold=0.0, bm=128, bk=128)[:M, :N]
    y_r = ref.em_ops.event_matmul(jnp.asarray(x), jnp.asarray(w),
                                  threshold=thr, bm=bm, bk=128, bn=128)
    np.testing.assert_allclose(y_p.numpy(), np.asarray(y_r), **FLOAT_TOL)
    y_w = em.event_matmul(torch.from_numpy(x), torch.from_numpy(w),
                          threshold=thr, bm=bm, bk=128)
    np.testing.assert_allclose(y_p.numpy(), y_w.numpy(), **FLOAT_TOL)
    occ = em.weight_block_occupancy(torch.from_numpy(w), 128, 128)
    y_j = em.event_matmul2(torch.from_numpy(x), torch.from_numpy(w), occ,
                           threshold=thr, bm=bm, bk=128, bn=128)
    np.testing.assert_allclose(y_p.numpy(), y_j.numpy(), **FLOAT_TOL)


def test_kernel_layout_and_splits():
    """The weights' kernel layout is the padded transpose, exactly; a
    split never exceeds its bounds and is 1 once the tiles fill the
    card."""
    w = torch.arange(300 * 130, dtype=torch.float32).reshape(300, 130)
    wt = em.kernel_layout(w)
    assert wt.shape == (256, 384) and wt.is_contiguous()
    assert torch.equal(wt[:130, :300], w.T)
    assert bool((wt[130:] == 0).all()) and bool((wt[:, 300:] == 0).all())
    kw = em.KernelWeights(w)
    assert kw.wt is None and kw.occ is None          # built for CUDA only
    with pytest.raises(ValueError):
        em.KernelWeights(w, torch.ones((2, 2), dtype=torch.bool))
    for tiles in (1, 16, 28, 112, 131):
        for kb in (1, 2, 4, 16, 64):
            s = em.kernel_splits(tiles, kb, 132)
            assert 1 <= s <= max(1, min(em.MAX_SPLITS, kb // 2))
    assert em.kernel_splits(256, 8, 132) == em.kernel_splits(132, 64, 132) \
        == em.kernel_splits(0, 8, 132) == 1
    assert em.kernel_splits(28, 16, 132) == 8       # whisper's fc2 at M 448


# ----------------------------------------------- the sigma-delta encoder


@pytest.mark.parametrize("shape", [(32, 512), (7, 300), (4, 16, 128),
                                   (1, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sigma_delta_encode_matches_reference_exactly(ref, shape, dtype):
    rng = np.random.default_rng(sum(shape))
    a_r, a_p = _both(rng.normal(size=shape).astype(np.float32), dtype)
    s_r, s_p = _both(rng.normal(size=shape).astype(np.float32), dtype)
    q_r, sn_r = ref.sd_ops.sigma_delta_encode(a_r, s_r, theta=0.1)
    q_p, sn_p = repro_torch.kernels.sigma_delta_encode(a_p, s_p, theta=0.1)
    assert q_p.dtype == sn_p.dtype == a_p.dtype
    assert tuple(q_p.shape) == shape
    assert np.array_equal(_np(q_p), _np(q_r))
    assert np.array_equal(_np(sn_p), _np(sn_r))
    q_o, sn_o = ref.sd_ref.sigma_delta_ref(a_r, s_r, theta=0.1)
    assert np.array_equal(_np(q_p), _np(q_o))
    assert np.array_equal(_np(sn_p), _np(sn_o))
    if q_p.numel() > 1:
        assert (q_p != 0).any() and (q_p == 0).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [0.25, 0.1])
def test_sigma_delta_encode_edge_cases_match_reference(ref, dtype, theta):
    """|delta| == theta exactly, half-integer delta / theta (half to even),
    negative deltas, and deltas one ulp either side of theta."""
    t32 = np.float32(theta)
    above = np.nextafter(t32, np.float32(1))
    below = np.nextafter(t32, np.float32(0))
    delta = np.array([t32, -t32, above, below, -below, 0.0,
                      0.375, 0.625, -0.375, -0.625, 0.875, -0.875,
                      2.5 * t32, -2.5 * t32, 3.5 * t32, -1.5 * t32],
                     np.float32)
    s = np.linspace(-1.0, 1.0, delta.size).astype(np.float32)
    s[:6] = 0.0                           # exact deltas where it matters
    a = (s + delta).astype(np.float32)
    a = np.stack([a, -a, a * 4])          # negative and larger deltas
    s = np.stack([s, -s, s * 4])
    a_r, a_p = _both(a, dtype)
    s_r, s_p = _both(s, dtype)
    q_r, sn_r = ref.sd_ops.sigma_delta_encode(a_r, s_r, theta=theta)
    q_p, sn_p = sd.sigma_delta_encode(a_p, s_p, theta=theta)
    assert np.array_equal(_np(q_p), _np(q_r))
    assert np.array_equal(_np(sn_p), _np(sn_r))
    if dtype == "float32":
        q = q_p.numpy()
        assert q[0, 0] == t32 and q[0, 1] == -t32     # |delta| == theta
        assert q[0, 2] == t32 and q[0, 3] == 0.0      # one ulp either side
        if theta == 0.25:                             # delta / theta exact
            # 1.5 -> 2, 2.5 -> 2, -1.5 -> -2, -2.5 -> -2, 3.5 -> 4
            assert list(q[0, 6:12] / t32) == [2, 2, -2, -2, 4, -4]


def test_sigma_delta_encode_validates_and_counts_only_launches(ref):
    a = torch.ones(4, 4)
    before = sd.sigma_delta_encode.launches
    q, s_new = sd.sigma_delta_encode(a, torch.zeros_like(a), theta=0.05)
    assert sd.sigma_delta_encode.launches == before   # plain version
    q2, _ = sd.sigma_delta_encode(a, s_new, theta=0.05)
    assert bool((q2 == 0).all())                      # steady state: silent
    for theta in (0.0, -0.1):
        with pytest.raises(ValueError):
            sd.sigma_delta_encode(a, a, theta=theta)
    with pytest.raises(ValueError):
        sd.sigma_delta_encode(a, torch.zeros(4, 5), theta=0.1)
    assert torch.equal(q, sigma_delta_ref(a, torch.zeros_like(a),
                                          theta=0.05)[0])
