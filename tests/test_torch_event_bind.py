"""The event matmul's bind: the plain version (``ref.bind_ref``) against
the host's own padding, activity map and mask cast on the CPU, and, on a
card, the one library call a layer makes (``event_matmul_pair_launch``:
the ``event_bind`` kernel, then each product) against the plain products.

The card tests skip without one (decided in the ``card`` fixture); run
them there with ``python -m pytest -q --noconftest
tests/test_torch_event_bind.py`` (this file imports no JAX)."""

import importlib.util
import pathlib

import pytest
import torch

from repro_torch import trace
from repro_torch.configs import registry
from repro_torch.kernels.event_matmul import ops as em
from repro_torch.kernels.event_matmul.ref import (bind_ref,
                                                  block_activity_ref,
                                                  event_matmul2_ref,
                                                  reads_in_place)
from repro_torch.neuromorphic import EventCompute, fc_network, make_inputs
from repro_torch.neuromorphic.frontend import lowering_spec

T = em.KERNEL_TILE
#: Rows of whisper-base's decode448 jobs, ragged and edge rows.
MS = (1, 447, 448, 512)
#: Fanins: a conv patch, whisper-base's widths, its 8 x 1,500 values maps.
KS = (27, 512, 2048, 3584, 12000)


def _pad(a):
    return em._pad_to(a, (T, T))


def _bits(a):
    """``a``'s bits: equal bits are the same copy, NaN included."""
    return a.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[
        a.element_size()])


def _cases(M: int, K: int, seed: int = 0):
    """(x, m) pairs: the delta path's (values and wire events differ,
    whole tiles of each dead), NaN entries in both, and all zeros."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((M, K), generator=g) * (
        torch.rand((M, K), generator=g) < 0.3)
    m = (torch.rand((M, K), generator=g) < 0.2).to(torch.float32)
    x[:, T:2 * T] = 0.0
    m[:, :T] = 0.0
    x[T:2 * T] = 0.0
    xn, mn = x.clone(), m.clone()
    xn[0, 0] = float("nan")
    mn[-1, -1] = float("nan")
    return [(x, m), (xn, mn), (torch.zeros(M, K), torch.zeros(M, K))]


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("M", MS)
def test_bind_ref_matches_the_host_bind(M, K):
    """Activity maps, int8 operand and the copy-or-in-place decision of
    the plain bind equal ``block_activity_ref(_pad_to(...))`` and ``(m !=
    0).to(torch.int8)``: NaN kills a value tile and is a wire event."""
    in_place = K % T == 0 and M % em.KERNEL_ROWS == 0
    for x, m in _cases(M, K):
        b = bind_ref(x, m)
        m8 = (m != 0).to(torch.int8)
        assert torch.equal(b.active, block_activity_ref(_pad(x), 0.0, T, T))
        assert torch.equal(b.mask_active,
                           block_activity_ref(_pad(m8), 0.0, T, T))
        assert reads_in_place(x) is in_place
        assert b.copies == (0 if in_place else 2)
        if in_place:
            assert b.operand is x and torch.equal(b.mask, m8)
        else:
            assert torch.equal(_bits(b.operand), _bits(_pad(x)))
            assert torch.equal(b.mask, _pad(m8))
    x, m = _cases(M, K)[1]
    if M > 1:
        assert not bool(bind_ref(x, m).active[0, 0])      # NaN: no event
        assert bool(bind_ref(x, m).mask_active[-1, -1])   # NaN: an event


@pytest.mark.parametrize("threshold", [0.0, 0.05])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_bind_ref_kinds_and_thresholds(dtype, threshold):
    """A value product alone: the map compares in the operand's type (the
    threshold rounded to bfloat16 for bfloat16) and int8's |-128| wraps,
    as PyTorch's ``abs`` and ``amax`` do."""
    g = torch.Generator().manual_seed(3)
    x = (torch.rand((300, 333), generator=g) * 0.1 - 0.05)
    x[:, :T] = torch.where(x[:, :T].abs() > 0.045, 0.05, 0.0)
    if dtype == torch.int8:
        x = (x > 0.02).to(torch.int8)
        x[200, 300] = -128
    else:
        x = x.to(dtype)
        x[5, 5] = float("nan")
    b = bind_ref(x, threshold=threshold)
    assert torch.equal(b.active,
                       block_activity_ref(_pad(x), threshold, T, T))
    assert b.mask is None and b.copies == 1
    assert torch.equal(_bits(b.operand), _bits(_pad(x)))


def test_reads_in_place_needs_packed_aligned_rows():
    x = torch.zeros(448, 512)
    assert reads_in_place(x)
    assert not reads_in_place(torch.zeros(512, 448).T)     # not row-major
    assert not reads_in_place(torch.zeros(448 * 512 + 1)[1:].view(448, 512))
    assert not reads_in_place(torch.zeros(448, 640)[:, :512])
    assert not reads_in_place(torch.zeros(447, 512))
    assert reads_in_place(torch.zeros(448, 1024, dtype=torch.int8))


def test_whisper_base_copies_only_its_12000_fanins():
    """At decode448's 448 rows, whisper-base's five fanins read in place
    but 8 x 1,500 = 12,000 (the encoder self- and decoder cross-attention
    values maps): 24 of a stream's 194 products are copied."""
    specs, _ = lowering_spec(registry.get("whisper-base").config,
                             seq_len=448)
    copies = {}
    for fanin in sorted({s.fanin for s in specs}):
        x = torch.zeros(448, fanin)
        copies[fanin] = bind_ref(x, x).copies
    assert copies == {512: 0, 1536: 0, 3584: 0, 4096: 0, 12000: 2}
    assert 2 * len(specs) == 194
    assert sum(copies[s.fanin] for s in specs) == 24


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
    return module.EM_TOL


def _weights(K: int, N: int, seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    w = torch.randn((K, N), generator=g) / K ** 0.5
    w[:, T:2 * T] = 0.0                        # a dead n tile
    w[:min(K, T)] *= (torch.rand((min(K, T), N), generator=g) < 0.5)
    return w


def _joint_live(active, occ) -> int:
    return int(em._compact_indices_joint(active, occ)[1].sum())


@pytest.mark.parametrize("K", KS)
@pytest.mark.parametrize("M", MS)
def test_pair_call_matches_plain_products(card, M, K):
    """A layer's one library call: ``y`` within the float32 tolerance of
    the plain product and ``macs`` exact, each product counted as a
    launch, and the recorded counts exact: live tiles of both products
    and the operands copied to a padded layout."""
    rtol, atol = _em_tol()["float32"]
    N = 300
    w = _weights(K, N)
    occ = em.weight_block_occupancy(w)
    kw = em.KernelWeights(w.to(card), occ.to(card))
    kw8 = em.KernelWeights((w != 0).to(torch.int8).to(card), occ.to(card))
    for x, m in _cases(M, K)[::2]:
        before = em.event_matmul2.launches
        with trace.recording() as rec:
            y, macs = em.event_matmul_pair_packed(x.to(card), m.to(card),
                                                  kw, kw8)
        assert em.event_matmul2.launches == before + 2
        b = bind_ref(x, m)
        y_ref = event_matmul2_ref(_pad(x), _pad(w), occ, threshold=0.0,
                                  bm=T, bk=T, bn=T)[:M, :N]
        m8 = (m != 0).to(torch.int8)
        macs_ref = event_matmul2_ref(_pad(m8), _pad((w != 0).to(torch.int8)),
                                     occ, threshold=0.0, bm=T, bk=T, bn=T,
                                     out_dtype=torch.float32)[:M, :N]
        torch.testing.assert_close(y.cpu(), y_ref, rtol=rtol, atol=atol)
        assert torch.equal(macs.cpu(), macs_ref)
        assert rec.count("event_matmul.padded_copies") == b.copies
        assert rec.count("event_matmul2.live_tiles") == (
            _joint_live(b.active, occ) + _joint_live(b.mask_active, occ))
        mb, kb = b.active.shape
        assert rec.count("event_matmul2.tiles") == 2 * mb * kb * occ.shape[1]


@pytest.mark.parametrize("threshold", [0.0, 0.05])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_single_products_match_plain_versions(card, dtype, threshold):
    """Value products alone through the same entry, each wrapper on the
    card against its plain version on the CPU: joint and 1-D, three
    kinds, a threshold, 64-wide tiles, ragged and edge shapes; int8
    counts exact."""
    calls = {
        "joint": lambda a, b: em.event_matmul2(
            a, b, em.weight_block_occupancy(b), threshold=threshold),
        "1-D": lambda a, b: em.event_matmul(a, b, threshold=threshold),
        "64-wide": lambda a, b: em.event_matmul2(
            a, b, em.weight_block_occupancy(b, 64, 64), threshold=threshold,
            bm=64, bk=64, bn=64)}
    for M, K in ((447, 333), (448, 512), (1, 27)):
        x, _ = _cases(M, K)[0]
        w = _weights(K, 200)
        if dtype == torch.int8:
            x, w = (x != 0).to(dtype), (w != 0).to(dtype)
        else:
            x, w = x.to(dtype), w.to(dtype)
        for name, fn in calls.items():
            want, got = fn(x, w), fn(x.to(card), w.to(card)).cpu()
            assert got.dtype == want.dtype and got.shape == want.shape
            if dtype == torch.int8:
                assert torch.equal(got, want), name
            else:
                rtol, atol = _em_tol()[str(dtype)[6:]]
                torch.testing.assert_close(got.float(), want.float(),
                                           rtol=rtol, atol=atol, msg=name)


def test_run_batch_binds_each_layer_in_one_call(card):
    """``run_batch`` in kernel mode still counts 2 x L ``event_matmul2``
    launches, its counters equal the dense backend's bit for bit, and the
    padded copies are the ragged fanins' pairs alone."""
    sizes = [300, 256, 200, 64]
    net = fc_network(sizes, weight_density=0.5, seed=0, device=card)
    xs = make_inputs(sizes[0], 0.3, 448, seed=1, device=card)
    before = em.event_matmul2.launches
    with trace.recording() as rec:
        out_k, cnt_k = net.run_batch(xs, compute=EventCompute(mode="kernel"))
    torch.cuda.synchronize()
    assert em.event_matmul2.launches == before + 2 * len(net.layers)
    assert rec.count("event_matmul.padded_copies") == 2 * sum(
        K % T != 0 for K in sizes[:-1])
    out_d, cnt_d = net.run_batch(xs, compute="dense")
    for a, b in zip(cnt_k, cnt_d):
        for f in ("msgs_in", "macs", "fetches_dense", "msgs_out",
                  "acts_evented"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


#: ``EventCompute``'s kernel option sets other than the defaults, as the
#: threshold and tile tests of ``test_torch_event_options.py`` run them.
OPTION_SETS = {"threshold-tiles16": dict(threshold=0.3, bm=16, bk=16),
               "tiles64": dict(bm=64, bk=64),
               "tiles64-bn32": dict(bm=64, bk=64, bn=32)}


@pytest.mark.parametrize("name", sorted(OPTION_SETS))
def test_option_sets_take_one_call_a_layer(card, name):
    """Every option set reaches the kernel through the layer's own
    weights in one library call: one ``event_matmul.launch`` span for
    each ``forward`` and ``value_forward`` of a layer (two and one
    ``event_matmul2`` launches), and the bits of the same products made
    by two public ``event_matmul2`` calls on the raw weights and (bk, bn)
    occupancy, values and counters alike."""
    kw = OPTION_SETS[name]
    bm, bk, bn = (kw.get(k, T) for k in ("bm", "bk", "bn"))
    thr = kw.get("threshold", 0.0)
    ec = EventCompute(mode="kernel", **kw)
    net = fc_network([300, 256, 200, 64], weight_density=0.5, seed=0,
                     device=card)
    for i, layer in enumerate(net.layers):
        x, m = _cases(448, layer.fanin, seed=i)[0]
        x = (x * 0.5).to(card)      # entries on both sides of 0.3
        m = (x != 0).to(torch.float32)
        msgs = m.sum(dim=1)
        before = em.event_matmul2.launches
        with trace.recording() as rec:
            pre, macs, _ = ec.forward(layer, x, m, msgs)
            values = ec.value_forward(layer, x)
        torch.cuda.synchronize()
        assert len([s for s in rec.spans
                    if s.name == "event_matmul.launch"]) == 2
        assert em.event_matmul2.launches == before + 3
        w = layer.weights
        occ = em.weight_block_occupancy(w, bk, bn)
        want = em.event_matmul2(x, w, occ, threshold=thr, bm=bm, bk=bk,
                                bn=bn)
        want_macs = em.event_matmul2(
            (m != 0).to(torch.int8), (w != 0).to(torch.int8), occ, bm=bm,
            bk=bk, bn=bn)
        for got, ref in ((pre, want), (values, want), (macs, want_macs)):
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
