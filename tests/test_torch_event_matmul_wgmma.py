"""The float32 event matmul's ``wgmma`` body: on the CPU, the plain TF32
split that :class:`KernelWeights` makes of float32 weights (its bits
against ``cvt.rna.tf32.f32`` worked out by hand) and the wrapper's plan of
a call (body, splits, workspace) at the benchmark cells' shapes; on a
card, the body against the float64 product and the plain version, its
edges, and repeated launches bit for bit.

The card tests skip without one (decided in the ``card`` fixture); run
them there with ``python -m pytest -q --noconftest
tests/test_torch_event_matmul_wgmma.py`` (this file imports no JAX)."""

import importlib.util
import pathlib

import pytest
import torch

from repro_torch.kernels.event_matmul import ops as em
from repro_torch.kernels.event_matmul.ref import (block_activity_ref,
                                                  event_matmul2_ref,
                                                  tf32_rna_ref,
                                                  tf32_split_ref)

T = em.KERNEL_TILE
SMS = 132                                     # an H100 SXM


def _f32(bits):
    return torch.tensor(bits, dtype=torch.int64).to(torch.int32).view(
        torch.float32)


def _bits(a):
    return [v & 0xFFFFFFFF for v in a.view(torch.int32).tolist()]


# ------------------------------------------------------- the TF32 split
#: (input bits, ``cvt.rna.tf32.f32`` bits): half a TF32 ulp is 0x1000;
#: the NaN rows as an H100 gives them (the low 13 bits cleared).
RNA_CASES = {
    "exact": (0x3F802000, 0x3F802000),
    "below half": (0x3F800FFF, 0x3F800000),
    "tie away from zero": (0x3F801000, 0x3F802000),
    "negative tie away from zero": (0xBF801000, 0xBF802000),
    "above half": (0x3F803001, 0x3F804000),
    "negative below half": (0xBF803FFF, 0xBF804000),
    "carry into the exponent": (0x3FFFF000, 0x40000000),
    "negative carry into the exponent": (0xBFFFF000, 0xC0000000),
    "zero": (0x00000000, 0x00000000),
    "negative zero": (0x80000000, 0x80000000),
    "smallest subnormal": (0x00000001, 0x00000000),
    "subnormal tie": (0x00001000, 0x00002000),
    "negative subnormal": (0x80003FFF, 0x80004000),
    "largest subnormal to the smallest normal": (0x007FFFFF, 0x00800000),
    "largest TF32 value": (0x7F7FE000, 0x7F7FE000),
    "largest float32 to inf": (0x7F7FFFFF, 0x7F800000),
    "largest float32 to -inf": (0xFF7FFFFF, 0xFF800000),
    "just below the overflow tie": (0x7F7FEFFF, 0x7F7FE000),
    "inf": (0x7F800000, 0x7F800000),
    "-inf": (0xFF800000, 0xFF800000),
    "quiet NaN": (0x7FC00000, 0x7FC00000),
    "NaN with a low payload": (0x7F800001, 0x7F800000),
    "negative NaN": (0xFFC00123, 0xFFC00000),
}


@pytest.mark.parametrize("case", sorted(RNA_CASES))
def test_tf32_rna_ref_gives_cvt_rna_bits(case):
    """Round to nearest, ties away from zero, on the magnitude's bits:
    the carry crosses into the exponent and out of the subnormals, a
    finite value past TF32's largest becomes inf, inf stays, NaN loses
    its low 13 bits."""
    x, want = RNA_CASES[case]
    assert _bits(tf32_rna_ref(_f32([x]))) == [want]


def test_tf32_split_halves_recover_each_value():
    """``hi`` and ``lo`` are TF32 values (low 13 bits clear) and ``hi +
    lo`` is within 2^-22 of every normal value, relative; ``lo`` is the
    rounded remainder, exactly ``tf32_rna(w - hi)``."""
    g = torch.Generator().manual_seed(0)
    w = torch.cat([torch.randn(100_000, generator=g),
                   torch.randn(1_000, generator=g) * 1e30,
                   torch.randn(1_000, generator=g) * 1e-30,
                   _f32([0x3F801000, 0xBF801000, 0x3F800FFF, 0x7F7FE000])])
    hi, lo = tf32_split_ref(w)
    for half in (hi, lo):
        assert bool(((half.view(torch.int32) & 0x1FFF) == 0).all())
    assert torch.equal(lo.view(torch.int32),
                       tf32_rna_ref(w - hi).view(torch.int32))
    err = ((hi.double() + lo.double()) - w.double()).abs()
    assert bool((err <= 2.0 ** -22 * w.double().abs()).all())
    assert float(err.max()) > 0.0                    # lo is rounded too


def test_tf32_split_keeps_zeros_and_specials():
    w = _f32([0x00000000, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000])
    hi, lo = tf32_split_ref(w)
    assert _bits(hi) == [0, 0x80000000, 0x7F800000, 0xFF800000,
                         0x7FC00000]
    assert _bits(lo)[:2] == [0, 0]
    assert bool(lo[2:].isnan().all())          # inf - inf and NaN - NaN


def test_tf32_split_is_shape_preserving_and_leaves_its_input():
    w = torch.randn(3, 5, 7)
    before = w.clone()
    hi, lo = tf32_split_ref(w)
    assert hi.shape == lo.shape == w.shape
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(w, before)


def test_kernel_weights_build_no_layout_on_the_cpu():
    """On the CPU no kernel layout is built, halves or not (the halves'
    layout is checked on the card below)."""
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        kw = em.KernelWeights(torch.zeros(300, 130).to(dtype))
        assert kw.wt is None and kw.occ is None


# --------------------------------------------------- the plan of a call
#: The float32 products of the benchmark's cells: (M, K, N, joint).
#: mamba2-1.3b-6of48: ``in``, ``state`` (K 8,512: a padded copy),
#: ``out`` and the head; whisper-base at 448 rows: the model's widths and
#: the 8 x 1,500 attention maps.
CELL_SHAPES = {
    "mamba2 in": (1024, 2048, 8512, False),
    "mamba2 state": (1024, 8512, 4096, True),
    "mamba2 out": (1024, 4096, 2048, False),
    "mamba2 head": (1024, 2048, 50277, False),
    "whisper 512 -> 512": (448, 512, 512, False),
    "whisper 512 -> 2048": (448, 512, 2048, False),
    "whisper 2048 -> 512": (448, 2048, 512, False),
    "whisper maps 12000 -> 512": (448, 12000, 512, True),
    "whisper 512 -> 51865": (448, 512, 51865, False),
}


def _plan(M, K, N, *, pair=True):
    kp, np_ = -(-K // T) * T, -(-N // T) * T
    pad = bool(K % T or M % em.KERNEL_ROWS)
    return em.call_plan(torch.float32, M, kp, np_, SMS, pair=pair,
                        pad_x=pad, pad_m=pad and pair), kp, np_


@pytest.mark.parametrize("name", sorted(CELL_SHAPES))
def test_call_plan_at_the_cells_shapes(name):
    """Every float32 product takes the ``wgmma`` body, whose splits fill
    at most one wave of 128-row tiles (one block an SM); the counter's
    keep the 64-row rule; the workspace holds the maps, the copies and
    the larger product's partials, each part carved to 256 bytes."""
    M, K, N, _ = CELL_SHAPES[name]
    plan, kp, np_ = _plan(M, K, N)
    mp = -(-M // T) * T
    mb, nb, kb = mp // T, np_ // T, kp // T
    tiles = mb * nb
    assert plan.splits == em.wgmma_splits(tiles, kb, SMS)
    assert tiles * plan.splits <= max(tiles, SMS)
    assert plan.splits_m == em.kernel_splits(-(-M // 64) * nb, kb, SMS)
    pad = bool(K % T)
    most = max(plan.splits, plan.splits_m)

    def carve(n):
        return -(-n // 256) * 256
    want = (2 * carve(mb * kb) + (carve(mp * kp * 4) if pad else 0)
            + carve((mp if pad else M) * kp)
            + (carve(most * mp * np_ * 4) if most > 1 else 0))
    assert plan.ws_bytes == want
    assert plan.ws_bytes % 256 == 0


def test_call_plan_of_a_value_product_alone():
    plan, kp, np_ = _plan(448, 512, 512, pair=False)
    assert plan.splits_m == 1
    assert plan.ws_bytes == (-(-(4 * 4) // 256) * 256 + (
        plan.splits * 512 * np_ * 4 if plan.splits > 1 else 0))


def test_mamba2_products_fill_the_card_without_splits():
    """At M = 1,024 every dense mamba2 product has 128 tiles or more of
    128 rows: one block a tile, no partials, no reduction."""
    for name in ("mamba2 in", "mamba2 out", "mamba2 head", "mamba2 state"):
        M, K, N, _ = CELL_SHAPES[name]
        plan, _, _ = _plan(M, K, N)
        assert plan.splits == 1, name


@pytest.mark.parametrize("tiles,kb,want", [
    (0, 8, 1), (132, 64, 1), (536, 16, 1), (128, 32, 1),
    (66, 16, 2), (16, 4, 2), (16, 16, 8), (28, 16, 4), (1, 1, 1),
    (1, 64, 8), (4, 3, 1)])
def test_wgmma_splits(tiles, kb, want):
    """One wave at most: floor(sms / tiles), capped by MAX_SPLITS and by
    half the k tiles."""
    assert em.wgmma_splits(tiles, kb, SMS) == want


def test_other_kinds_keep_the_mma_sync_body():
    for dtype in (torch.bfloat16, torch.int8):
        plan = em.call_plan(dtype, 448, 512, 512, SMS, pair=False,
                            pad_x=False, pad_m=False)
        assert plan.splits == em.kernel_splits(7 * 4, 4, SMS)
        plan = em.call_plan(dtype, 1024, 2048, 8576, SMS, pair=False,
                            pad_x=False, pad_m=False)
        assert plan.splits == 1


# ------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _em_tol():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.EM_TOL["float32"]


def _operands(M, K, N, *, seed=0, x_density=1.0, dead=False, card=None):
    """x (M, K) and w (K, N) scaled by 1 / sqrt(K), so that outputs are of
    order one; with ``dead``, whole k tiles of x and n tiles of w zero."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((M, K), generator=g)
    if x_density < 1.0:
        x *= torch.rand((M, K), generator=g) < x_density
    w = torch.randn((K, N), generator=g) / K ** 0.5
    if dead:
        x[:, T:2 * T] = 0.0
        x[:min(M, T), 2 * T:4 * T] = 0.0
        w[:, T:2 * T] = 0.0
        w[3 * T:4 * T] = 0.0
    return x.to(card), w.to(card)


def _wants(x, w, joint):
    """The float64 product and the plain version (float32), on the card,
    of the product the kernel takes: dead activation tiles (and, joint,
    unoccupied weight tiles) zeroed."""
    occ = em.weight_block_occupancy(w) if joint else torch.ones(
        -(-w.shape[0] // T), -(-w.shape[1] // T), dtype=torch.bool,
        device=w.device)
    xp, wp = em._pad_to(x, (T, T)), em._pad_to(w, (T, T))
    M, N = x.shape[0], w.shape[1]
    plain = event_matmul2_ref(xp, wp, occ, threshold=0.0, bm=T, bk=T,
                              bn=T)[:M, :N]
    live = block_activity_ref(xp, 0.0, T, T)
    xm = torch.where(live.repeat_interleave(T, 0).repeat_interleave(T, 1),
                     xp, 0.0)
    wm = torch.where(occ.repeat_interleave(T, 0).repeat_interleave(T, 1),
                     wp, 0.0)
    exact = (xm.double() @ wm.double())[:M, :N]
    return exact, plain


def _product(x, w, joint):
    occ = em.weight_block_occupancy(w) if joint else None
    before = em.event_matmul2.launches + em.event_matmul.launches
    y = em.event_matmul_packed(x, em.KernelWeights(w, occ))
    torch.cuda.synchronize()
    assert em.event_matmul2.launches + em.event_matmul.launches == (
        before + 1)
    return y


def _check(y, exact, plain, what):
    """``y`` within the float32 tolerance of the float64 product, and of
    the plain version with that version's own float32 error as the only
    slack (the plain product strays up to 1.9e-5 at K = 8,512, the
    kernel's promoted 3xTF32 sum about 4e-6)."""
    rtol, atol = _em_tol()
    torch.testing.assert_close(y.double(), exact, rtol=rtol, atol=atol,
                               msg=what)
    slack = (plain.double() - exact).abs()
    gap = (y - plain).abs().double() - rtol * plain.abs().double() - slack
    assert float(gap.max()) <= atol, what


#: The cells' float32 products, joint and 1-D: (M, K, N).
CARD_SHAPES = {
    "mamba2 in": (1024, 2048, 8512),
    "mamba2 out": (1024, 4096, 2048),
    "mamba2 head": (1024, 2048, 50277),
    "mamba2 padded K": (1024, 8512, 4096),
    "whisper 448 x 512 -> 512": (448, 512, 512),
    "whisper 448 x 2048 -> 512": (448, 2048, 512),
}


@pytest.mark.parametrize("joint", [True, False], ids=["joint", "1-D"])
@pytest.mark.parametrize("name", sorted(CARD_SHAPES))
def test_card_products_at_the_cells_shapes(card, name, joint):
    """Within the float32 tolerance of the float64 product and of the
    plain version, on the ``wgmma`` body (the plan's choice for float32,
    pinned by :func:`test_call_plan_at_the_cells_shapes`)."""
    M, K, N = CARD_SHAPES[name]
    x, w = _operands(M, K, N, dead=joint, card=card)
    y = _product(x, w, joint)
    _check(y, *_wants(x, w, joint), name)


@pytest.mark.parametrize("joint", [True, False], ids=["joint", "1-D"])
@pytest.mark.parametrize("M,K,N", [(1, 27, 5), (63, 130, 129),
                                   (200, 333, 260), (447, 1000, 300),
                                   (129, 4096, 1)])
def test_card_ragged_edges(card, M, K, N, joint):
    """Ragged M, K and N (a padded copy where K or M is ragged, rows past
    M read as zeros where M is not), splits > 1 on the small grids."""
    x, w = _operands(M, K, N, seed=M + K, x_density=0.4, dead=joint,
                     card=card)
    y = _product(x, w, joint)
    assert y.shape == (M, N)
    _check(y, *_wants(x, w, joint), f"{M}x{K}x{N}")


@pytest.mark.parametrize("joint", [True, False], ids=["joint", "1-D"])
def test_card_empty_live_lists_write_zeros(card, joint):
    """An all-zero x (no live tile anywhere) and, joint, an all-zero w (no
    occupied tile) give exact zeros, over splits and none."""
    for M, K, N in ((448, 512, 512), (1024, 2048, 2048)):
        x, w = _operands(M, K, N, card=card)
        y = _product(torch.zeros_like(x), w, joint)
        assert bool((y == 0).all())
        if joint:
            y = _product(x, torch.zeros_like(w), joint)
            assert bool((y == 0).all())


def test_card_dead_tiles_are_exact_zeros(card):
    """A 128-row block whose activity is all dead, and an n tile whose
    weights are all unoccupied, are exact zeros beside live ones."""
    x, w = _operands(448, 1024, 512, card=card)
    x[128:256] = 0.0
    w[:, 256:384] = 0.0
    y = _product(x, w, True)
    assert bool((y[128:256] == 0).all()) and bool((y[:, 256:384] == 0).all())
    _check(y, *_wants(x, w, True), "dead tiles")


@pytest.mark.parametrize("M,K,N", [(1024, 2048, 8512), (448, 2048, 512),
                                   (1024, 8512, 4096)])
def test_card_repeated_launches_are_bit_identical(card, M, K, N):
    """A fixed k order a tile and split partials summed in split order:
    the same bits every launch."""
    x, w = _operands(M, K, N, x_density=0.5, dead=True, card=card)
    kw = em.KernelWeights(w, em.weight_block_occupancy(w))
    first = em.event_matmul_packed(x, kw).clone()
    for _ in range(3):
        assert torch.equal(em.event_matmul_packed(x, kw).view(torch.int32),
                           first.view(torch.int32))


@pytest.mark.parametrize("K", [1024, 8512])
def test_card_float32_level_error(card, K):
    """The promoted 3xTF32 sum stays at float32 accuracy over long
    contractions: within the tolerance of the float64 product at K =
    1,024 and 8,512, and no worse than twice the plain float32 product's
    own error."""
    x, w = _operands(1024, K, 1024, seed=K, card=card)
    y = _product(x, w, False)
    exact, plain = _wants(x, w, False)
    _check(y, exact, plain, f"K={K}")
    err = float((y.double() - exact).abs().max())
    err_plain = float((plain.double() - exact).abs().max())
    assert err <= 2 * err_plain + 1e-7, (err, err_plain)


def test_card_kernel_weights_halves(card):
    """float32 weights are kept as the padded transpose's TF32 split, hi
    then lo; the other kinds as the padded transpose."""
    w = torch.randn(300, 130).to(card)
    kw = em.KernelWeights(w)
    assert kw.wt.shape == (2, 256, 384) and kw.wt.is_contiguous()
    hi, lo = tf32_split_ref(em.kernel_layout(w))
    assert torch.equal(kw.wt[0].view(torch.int32), hi.view(torch.int32))
    assert torch.equal(kw.wt[1].view(torch.int32), lo.view(torch.int32))
    for dtype in (torch.bfloat16, torch.int8):
        wd = w.to(dtype)
        assert torch.equal(em.KernelWeights(wd).wt, em.kernel_layout(wd))


def test_card_kernel_split_gives_cvt_rna_bits(card):
    """The split the ``wgmma`` body makes of x (``cvt.rna`` on the card,
    run alone through ``tf32_split_launch``) gives each hand-built
    pattern's bits, and both halves of the plain split that makes the
    weights', on the patterns and on random words of every exponent."""
    from repro_torch.kernels import build
    names = sorted(RNA_CASES)
    g = torch.Generator().manual_seed(3)
    rand = torch.randint(-2 ** 31, 2 ** 31, (4096,), generator=g,
                         dtype=torch.int64).to(torch.int32).view(
                             torch.float32)
    x = torch.cat([_f32([RNA_CASES[c][0] for c in names]), rand]).to(card)
    hi, lo = torch.empty_like(x), torch.empty_like(x)
    build.check(build.load().tf32_split_launch(
        x.data_ptr(), hi.data_ptr(), lo.data_ptr(), x.numel(),
        torch.cuda.current_stream().cuda_stream), "tf32_split")
    torch.cuda.synchronize()
    got = _bits(hi[:len(names)].cpu())
    wrong = {c: (hex(RNA_CASES[c][1]), hex(b)) for c, b in zip(names, got)
             if b != RNA_CASES[c][1]}
    assert not wrong, wrong
    want_hi, want_lo = tf32_split_ref(x)
    assert _bits(hi.cpu()) == _bits(want_hi.cpu())
    assert _bits(lo.cpu()) == _bits(want_lo.cpu())
