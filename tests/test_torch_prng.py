"""The port's threefry (``repro_torch.core.prng``) against ``jax.random``,
bit for bit, on the CPU.

The JAX package's device search draws everything from ``jax.random`` with
JAX's partitionable threefry layout.  The port's draws must be the same
bits: keys, splits and fold-ins, 32- and 64-bit raw draws, int32
``randint`` and float64 ``uniform``, the serving engine's float32
``uniform_f32`` (with a range), ``gumbel`` and ``categorical``, the model
init's ``truncated_normal`` and XLA's float32 ``erf`` under it, draws
made in chunks from an offset, and the device search's own
``generation_draws`` and ``island_keys``, over a grid of shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from _repro_reference import reference
from repro_torch.core import prng
from repro_torch.core.device_search import (generation_draws, island_draws,
                                            island_keys)

SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 32 + 3]
SHAPES = [(1,), (7,), (3, 5), (64, 120)]
SPANS = [1, 2, 3, 7, 64, 1000]


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _key(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


def test_partitionable_layout_is_the_reference_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_matches_jax(seed):
    assert np.array_equal(prng.PRNGKey(seed).numpy(),
                          _key(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_match_jax(seed):
    k, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert np.array_equal(prng.split(kt, 8).numpy(),
                          _key(jax.random.split(k, 8)))
    assert np.array_equal(prng.split(kt).numpy(), _key(jax.random.split(k)))
    for g in range(65):
        assert np.array_equal(prng.fold_in(kt, g).numpy(),
                              _key(jax.random.fold_in(k, g)))
    assert prng.split_words(kt, 3) == [tuple(r) for r in
                                       prng.split(kt, 3).tolist()]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 42])
def test_random_bits_match_jax(seed, shape):
    k, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert np.array_equal(prng.random_bits(kt, 32, shape).numpy(),
                          _key(jax.random.bits(k, shape, jnp.uint32)))
    with jax.enable_x64():
        want = np.asarray(jax.random.bits(k, shape, jnp.uint64))
    assert np.array_equal(prng.random_bits(kt, 64, shape).numpy(),
                          want.view(np.int64))
    with pytest.raises(ValueError, match="bit_width"):
        prng.random_bits(kt, 16, shape)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("span", SPANS)
def test_randint_matches_jax(span, shape):
    for seed in (0, 7):
        k, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        want = np.asarray(jax.random.randint(k, shape, 0, span,
                                             dtype=jnp.int32))
        got = prng.randint(kt, shape, 0, span)
        assert got.dtype == prng.torch.int32
        assert np.array_equal(got.numpy(), want)
    # an offset range, an empty one, one reaching the int32 maximum
    for lo, hi in ((-5, 9), (4, 4), (3, 1), (0, 2 ** 31 - 1)):
        want = np.asarray(jax.random.randint(k, shape, lo, hi,
                                             dtype=jnp.int32))
        assert np.array_equal(prng.randint(kt, shape, lo, hi).numpy(), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_uniform_float64_matches_jax(shape):
    for seed in (0, 42):
        k, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        with jax.enable_x64():
            want = np.asarray(jax.random.uniform(k, shape,
                                                 dtype=jnp.float64))
        got = prng.uniform(kt, shape).numpy()
        assert got.dtype == np.float64 and np.array_equal(got, want)
        assert ((got >= 0.0) & (got < 1.0)).all()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 3.1),
                                   (float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform_float32_with_range_matches_jax(shape, lo, hi):
    for seed in SEEDS[:3]:
        got = prng.uniform_f32(prng.PRNGKey(seed), shape, lo, hi).numpy()
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                             jnp.float32, lo, hi))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("shape", SHAPES)
def test_gumbel_matches_jax(shape):
    for seed in SEEDS[:3]:
        got = prng.gumbel(prng.PRNGKey(seed), shape).numpy()
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_matches_jax(seed):
    logits = np.random.default_rng(seed % 1000).standard_normal(
        (4, 512)).astype(np.float32) * 3
    got = prng.categorical(prng.PRNGKey(seed), torch.from_numpy(logits))
    want = jax.random.categorical(jax.random.PRNGKey(seed),
                                  jnp.asarray(logits))
    assert got.tolist() == np.asarray(want).tolist()


def test_streams_in_one_pass_equal_streams_alone():
    keys = prng.split(prng.PRNGKey(5), 3)
    sizes = [4, 0, 9]
    b1, b2 = prng.draw_streams(keys, sizes)
    pos = 0
    for k, n in zip(keys, sizes):
        a1, a2 = prng.draw_streams([prng._words(k)], [n])
        assert np.array_equal(b1[pos:pos + n].numpy(), a1.numpy())
        assert np.array_equal(b2[pos:pos + n].numpy(), a2.numpy())
        pos += n


def test_erf_matches_xla_bit_for_bit():
    """XLA's float32 ``erf`` on a grid through its clamp at +-3.74 and on
    the bounds ``truncated_normal`` feeds it (``b / sqrt2`` as XLA
    computes it: a product with the float32 reciprocal)."""
    bounds = np.float32([-3.0, -2.0, -1.0, 1.0, 2.0, 3.0])
    rsqrt2 = np.float32(1.0) / np.float32(np.sqrt(2.0))
    x = np.concatenate([np.linspace(-5, 5, 100_001, dtype=np.float32),
                        bounds * rsqrt2, bounds / np.float32(np.sqrt(2.0)),
                        np.float32([0.0, -0.0, 1e-30, -1e-30])])
    want = np.asarray(jax.lax.erf(jnp.asarray(x)))
    got = prng._erf(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("lo,hi", [(-2.0, 2.0), (-1.0, 3.0)])
@pytest.mark.parametrize("shape", [(1,), (37, 11), (512, 1024)])
def test_truncated_normal_matches_jax(shape, lo, hi):
    """Seeds 0 to 2 on the fold-in key the model init draws its first leaf
    from; (-1, 3) reaches ``erf_inv``'s far branch (``-log1p(-u*u) >=
    5``)."""
    for seed in range(3):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
        want = np.asarray(jax.random.truncated_normal(k, lo, hi, shape,
                                                      jnp.float32))
        got = prng.truncated_normal(prng.fold_in(prng.PRNGKey(seed), 1),
                                    lo, hi, shape).numpy()
        assert got.shape == shape and got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        assert ((got > lo) & (got < hi)).all()


def _as_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.int64: torch.int64, torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype])


def test_chunked_draws_equal_the_one_pass_draw(monkeypatch):
    """Elements ``[start, start + n)`` of a draw, chunk after chunk (the
    last chunk shorter), are the one-pass draw's; so is a model leaf
    filled ``INIT_CHUNK`` elements at a time, or from an offset."""
    from repro_torch.models import layers
    key, n = prng.fold_in(prng.PRNGKey(4), 2), 1000
    draws = (lambda shape, start: prng.random_bits(key, 32, shape, None,
                                                   start),
             lambda shape, start: prng.random_bits(key, 64, shape, None,
                                                   start),
             lambda shape, start: prng.uniform_f32(key, shape, -0.5, 2.0,
                                                   None, start),
             lambda shape, start: prng.truncated_normal(key, -2.0, 2.0,
                                                        shape, None, start))
    for draw in draws:
        parts = torch.cat([draw((min(96, n - s),), s)
                           for s in range(0, n, 96)])
        assert torch.equal(_as_bits(parts), _as_bits(draw((n,), 0)))
    b1, b2 = prng.draw_streams([prng._words(key)] * 2, [5, 7], start=30)
    w1, w2 = prng.draw_streams([prng._words(key)], [40])
    assert torch.equal(b1, torch.cat([w1[30:35], w1[30:37]]))
    assert torch.equal(b2, torch.cat([w2[30:35], w2[30:37]]))
    for dtype in (torch.float32, torch.bfloat16):
        one, chunked = (torch.empty((25, 40), dtype=dtype) for _ in "ab")
        tail = torch.empty(100, dtype=dtype)
        layers._init(one, key, 40)
        monkeypatch.setattr(layers, "INIT_CHUNK", 96)
        layers._init(chunked, key, 40)
        layers._init(tail, key, 40, start=900)
        monkeypatch.undo()
        assert torch.equal(_as_bits(chunked), _as_bits(one))
        assert torch.equal(_as_bits(tail), _as_bits(one.view(-1)[900:]))


def _draws_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].numpy()
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name


@settings(max_examples=25, deadline=None)
@given(n_off=st.integers(1, 40), n_pop=st.integers(1, 300),
       n_layers=st.integers(1, 6), n_slots=st.integers(2, 130),
       tournament_k=st.integers(0, 4), seed=st.integers(0, 2 ** 31 - 1),
       gen=st.integers(0, 40))
def test_generation_draws_match_reference(ref, n_off, n_pop, n_layers,
                                          n_slots, tournament_k, seed, gen):
    key = jax.random.fold_in(jax.random.PRNGKey(seed), gen)
    with jax.enable_x64():
        want = jax.device_get(ref.device_search.generation_draws(
            key, n_off=n_off, n_pop=n_pop, n_layers=n_layers,
            n_slots=n_slots, tournament_k=tournament_k))
    kt = prng.fold_in(prng.PRNGKey(seed), gen)
    got = generation_draws(kt, n_off=n_off, n_pop=n_pop, n_layers=n_layers,
                           n_slots=n_slots, tournament_k=tournament_k,
                           device="cpu")
    _draws_equal(got, want)


@pytest.mark.parametrize("n_islands", [1, 2, 3, 8])
@pytest.mark.parametrize("gen", [0, 1, 5, 64])
def test_island_keys_and_draws_match_reference(ref, n_islands, gen):
    base, base_t = jax.random.PRNGKey(11), prng.PRNGKey(11)
    want = ref.device_search.island_keys(base, gen, n_islands)
    keys = island_keys(base_t, gen, n_islands)
    assert np.array_equal(keys.numpy(), _key(want))
    if n_islands == 1:          # one island is the device engine's stream
        assert np.array_equal(keys[0].numpy(),
                              _key(jax.random.fold_in(base, gen)))
    kw = dict(n_off=5, n_pop=9, n_layers=3, n_slots=20, tournament_k=3)
    got = island_draws(keys, device="cpu", **kw)
    with jax.enable_x64():
        parts = [jax.device_get(ref.device_search.generation_draws(
            want[i], **kw)) for i in range(n_islands)]
    _draws_equal(got, {k: np.concatenate([p[k] for p in parts])
                       for k in parts[0]})
