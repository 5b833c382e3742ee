"""``EventCompute``'s options against the JAX package's, on the CPU.

The options are the reference's eight: ``mode``, ``threshold``,
``bm``/``bk``/``bn``, ``gather_bm``, ``delta_mode`` and ``delta_window``
(the port names the reference's ``"pallas"`` mode ``"kernel"``).  The
first three tests port the reference's own windowed sigma-delta tests
(``tests/test_weight_sparse.py``, ``TestWindowedDeltaBackend``): each
holds the port to the reference run with the same options and, as the
reference's tests do, to the dense backend.  Then a threshold above zero
and tiles other than 128, held to the reference with the same options.

Those new cases run on copies of the reference tests' networks whose
weights, inputs and sigma-delta thresholds are multiples of 1/8: every
sum is then exact in float32, in any order.  With float32 data a
pre-activation within roundoff of a quantiser step can send a message in
one summation order and not another (ROADMAP, known differences), and
another tile size is another order: the port's gather mode at 64 x 32
weight tiles moved two of fc1's messages against the reference's on the
reference tests' own data, though neither package is at fault.

Both packages build the same networks from the same numpy RNG calls.
Integer counters compare bit for bit; outputs at ``FLOAT_TOL`` (rtol and
atol 1e-6: contraction order differs between the two BLAS paths).  The
reference's kernel mode runs Pallas in interpret mode, the port's its
kernels' plain versions on CPU tensors.
"""

import numpy as np
import pytest
import torch

from _repro_reference import reference
from repro_torch.neuromorphic import (EventCompute, fc_network,
                                      network_from_numpy)
from repro_torch.neuromorphic import compute as C
from repro_torch.neuromorphic.network import _exact_density_mask

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)
FIELDS = ("msgs_in", "macs", "fetches_dense", "msgs_out", "acts_evented")
CPU = dict(device="cpu")
MODES = {"gather": "gather", "kernel": "pallas"}   # port -> reference


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def sd_nets(ref, seed=0):
    """The reference test's sigma-delta chain (fc 64-48-32, threshold
    0.05, deltas sent) in both packages."""
    nets = (ref.network.fc_network([64, 48, 32], weight_density=0.5,
                                   seed=seed, neuron_model="sd_relu"),
            fc_network([64, 48, 32], weight_density=0.5, seed=seed,
                       neuron_model="sd_relu", **CPU))
    for net in nets:
        for layer in net.layers:
            layer.threshold = 0.05
            layer.sends_deltas = True
    return nets


def _eighths(a: np.ndarray) -> np.ndarray:
    """``a`` with each nonzero entry rounded to a nonzero multiple of 1/8
    (zeros, and so densities, kept)."""
    q = np.maximum(np.round(np.abs(a) * 8), 1) / 8
    return np.where(a != 0, np.sign(a) * q, a).astype(np.float32)


def exact(nets, xs):
    """``nets`` and ``xs`` on the 1/8 grid (sigma-delta threshold 1/8)."""
    for lr, lp in zip(nets[0].layers, nets[1].layers):
        w = _eighths(np.asarray(lr.weights))
        lr.weights, lp.weights = w, torch.from_numpy(w.copy())
        if lr.neuron_model == "sd_relu":
            lr.threshold = lp.threshold = 0.125
    return nets, _eighths(xs)


def conv_nets(ref, seed=3):
    """The reference suite's ``conv_stack(neuron_model="sd_relu",
    sends_deltas=True, threshold=0.05)``: conv -> conv -> fc on 8x8x2."""
    rng = np.random.default_rng(seed)
    specs, h, c_prev = [], 8, 2
    for i, c in enumerate((4, 8)):
        wgt = rng.normal(0, 1 / 3.0, (3, 3, c_prev, c)).astype(np.float32)
        wgt *= _exact_density_mask(wgt.shape, 0.6, rng)
        specs.append(dict(name=f"conv{i}", kind="conv", weights=wgt,
                          stride=2, in_hw=(h, h), neuron_model="sd_relu",
                          threshold=0.05, sends_deltas=True))
        h, c_prev = h // 2, c
    wfc = rng.normal(0, 0.3, (h * h * c_prev, 10)).astype(np.float32)
    specs.append(dict(name="fc", kind="fc", weights=wfc,
                      neuron_model="relu"))
    rn = ref.network.SimNetwork([ref.network.SimLayer(**s) for s in specs],
                                8 * 8 * 2)
    return rn, network_from_numpy(specs, 8 * 8 * 2, **CPU)


def options(ref, mode, **kw):
    """(reference EventCompute, port EventCompute) with the same
    options."""
    return (ref.compute.EventCompute(mode=MODES[mode], **kw),
            EventCompute(mode=mode, **kw))


def assert_matches(ref, nets, xs, pair, *, dense=True):
    """The port's run against the reference's with the same options
    (counters bit for bit, outputs at FLOAT_TOL); with ``dense``, also
    against the port's dense run, as the reference's
    ``assert_backends_match`` holds its own."""
    rn, pn = nets
    out_r, cnt_r = rn.run_batch(xs, compute=pair[0])
    xt = torch.from_numpy(xs)
    out_p, cnt_p = pn.run_batch(xt, compute=pair[1])
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), **FLOAT_TOL)
    for l, (a, b) in enumerate(zip(cnt_r, cnt_p)):
        for f in FIELDS:
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  getattr(b, f).numpy()), (l, f)
    if dense:
        out_d, cnt_d = pn.run_batch(xt, compute="dense")
        np.testing.assert_allclose(out_p.numpy(), out_d.numpy(), **FLOAT_TOL)
        for l, (a, b) in enumerate(zip(cnt_d, cnt_p)):
            for f in FIELDS:
                assert torch.equal(getattr(a, f), getattr(b, f)), (l, f)
    return cnt_p


def count_windows(monkeypatch):
    """Count the windowed reconstructions (host and kernel mode)."""
    calls = []
    for name in ("_window_reconstruct_host", "window_reconstruct"):
        fn = getattr(C, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append((_name, kw.get("window", a[-1] if a else None)))
            return _fn(*a, **kw)
        monkeypatch.setattr(C, name, spy)
    return calls


# ------------------------------------- the reference's windowed-delta tests

@pytest.mark.parametrize("mode,kw", [
    ("gather", dict(delta_window=16)),
    ("kernel", dict(delta_window=16)),
    ("gather", dict(delta_mode="cumsum")),
], ids=["gather-window", "kernel-window", "gather-cumsum"])
def test_sd_chain_quiet_stretch(ref, mode, kw, monkeypatch):
    nets = sd_nets(ref)
    xs = ref.network.make_inputs(64, 0.3, 64, seed=9)
    xs[20:60] = 0.0          # quiet stretch spanning whole windows
    calls = count_windows(monkeypatch)
    assert_matches(ref, nets, xs, options(ref, mode, **kw))
    # one delta layer (fc1); the cumsum mode never windows
    want = [] if kw.get("delta_mode") == "cumsum" else [16]
    assert [w for _, w in calls] == want


def test_window_path_engages(ref, monkeypatch):
    """The windowed path must actually run (not silently fall back): T >
    window with a nonzero accumulator through a quiet batch."""
    rn, pn = sd_nets(ref, seed=1)
    xs = ref.network.make_inputs(64, 0.5, 40, seed=10)
    pair = options(ref, "gather", delta_window=8)
    calls = count_windows(monkeypatch)
    out_w, _ = pn.run_batch(torch.from_numpy(xs), compute=pair[1])
    out_d, _ = pn.run_batch(torch.from_numpy(xs), compute="dense")
    np.testing.assert_allclose(out_w.numpy(), out_d.numpy(), **FLOAT_TOL)
    assert calls == [("_window_reconstruct_host", 8)]
    out_r, _ = rn.run_batch(xs, compute=pair[0])
    np.testing.assert_allclose(out_w.numpy(), np.asarray(out_r),
                               **FLOAT_TOL)


def test_conv_sd_chain_windowed(ref, monkeypatch):
    nets = conv_nets(ref)
    xs = ref.network.make_inputs(nets[0].in_size, 0.3, 24, seed=11)
    xs[8:16] = 0.0
    calls = count_windows(monkeypatch)
    assert_matches(ref, nets, xs, options(ref, "gather", delta_window=8))
    assert [w for _, w in calls] == [8, 8]


# --------------------------------------------- threshold and other tiles

@pytest.mark.parametrize("mode,kw", [
    ("gather", {}), ("kernel", dict(bm=16, bk=16))],
    ids=["gather", "kernel-16"])
def test_threshold_above_zero_matches_reference(ref, mode, kw):
    """An event is ``|x| > threshold``.  At 0.3 an input of one or two
    1/8 quanta is no event and three are (no entry lies at the
    threshold).  Rows 16 to 47 carry inputs of one quantum, so values
    drop sub-threshold work -- per row tile's columns in gather mode, per
    (bm, bk) tile in kernel mode (16 x 16 here) -- and differ from dense;
    counters count every wire event, so fc0's equal dense's, and all
    equal the reference's."""
    nets, xs = exact(sd_nets(ref), ref.network.make_inputs(64, 0.3, 160,
                                                           seed=9))
    xs[16:48] = np.sign(xs[16:48]) / 8
    xs[64:128] = 0.0
    pair = options(ref, mode, threshold=0.3, **kw)
    cnt = assert_matches(ref, nets, xs, pair, dense=False)
    out_p, _ = nets[1].run_batch(torch.from_numpy(xs), compute=pair[1])
    out_d, cnt_d = nets[1].run_batch(torch.from_numpy(xs), compute="dense")
    assert not torch.allclose(out_p, out_d, **FLOAT_TOL)   # it bites
    assert torch.equal(cnt[0].macs, cnt_d[0].macs)         # layer 0 exact


@pytest.mark.parametrize("mode,kw", [
    ("kernel", dict(bm=64, bk=64)),
    ("kernel", dict(bm=64, bk=64, bn=32)),
    ("gather", dict(bk=64, bn=32, gather_bm=16)),
], ids=["kernel-bm64", "kernel-bm64-bn32", "gather-bm16-tiles64x32"])
def test_other_tiles_match_reference(ref, mode, kw, monkeypatch):
    """Tiles other than 128 at threshold 0: exact against dense and the
    reference's; the default window is ``bm`` in kernel mode and
    ``max(8, gather_bm)`` in gather mode, in both packages."""
    nets, xs = exact(sd_nets(ref), ref.network.make_inputs(64, 0.3, 160,
                                                           seed=9))
    xs[32:128] = 0.0
    pair = options(ref, mode, **kw)
    calls = count_windows(monkeypatch)
    assert_matches(ref, nets, xs, pair)
    window = kw.get("bm", 128) if mode == "kernel" \
        else max(8, kw.get("gather_bm", 32))
    assert [w for _, w in calls] == [window]
    assert pair[0]._delta_window_size() == window


def test_fc_and_conv_threshold_kernel_tiles(ref):
    """A plain fc layer and a conv stack with entries on both sides of
    the threshold, kernel mode at bm 32 against the reference's."""
    rng = np.random.default_rng(5)
    nets, xs = exact(
        (ref.network.fc_network([96, 80, 40], weight_density=0.6, seed=4),
         fc_network([96, 80, 40], weight_density=0.6, seed=4, **CPU)),
        (rng.normal(0, 0.3, (70, 96))
         * (rng.random((70, 96)) < 0.3)).astype(np.float32))
    for pair in (options(ref, "kernel", threshold=0.2, bm=32, bk=32, bn=64),
                 options(ref, "gather", threshold=0.2, gather_bm=8)):
        assert_matches(ref, nets, xs, pair, dense=False)
    nets, xs = exact(conv_nets(ref, seed=2), ref.network.make_inputs(
        8 * 8 * 2, 0.3, 12, seed=4))
    for pair in (options(ref, "kernel", bm=64, bk=64, bn=64),
                 options(ref, "gather", bk=64, bn=64, gather_bm=8)):
        assert_matches(ref, nets, xs, pair)


@pytest.mark.parametrize("cell", ["fc", "conv"])
def test_kernel_weight_tiles_change_nothing(ref, cell):
    """Kernel mode lays its weights out at 128-wide tiles whatever ``bk``
    and ``bn`` are (their occupancy is the weights' own), and at
    threshold 0 zeroing the dead (128, 64) activation tiles leaves
    NaN-free inputs as they are: (bk, bn) = (64, 32) gives the defaults'
    outputs and counters exactly, on float32 data, with no structure
    built at 64 x 32."""
    if cell == "fc":
        _, net = sd_nets(ref)
        xs = ref.network.make_inputs(64, 0.3, 160, seed=9)
        xs[32:128] = 0.0
    else:
        _, net = conv_nets(ref)
        xs = ref.network.make_inputs(net.in_size, 0.3, 24, seed=11)
    xt = torch.from_numpy(xs)
    out_d, cnt_d = net.run_batch(xt, compute=EventCompute(mode="kernel"))
    out_t, cnt_t = net.run_batch(xt, compute=EventCompute(mode="kernel",
                                                          bk=64, bn=32))
    assert torch.equal(out_t, out_d)
    for l, (a, b) in enumerate(zip(cnt_d, cnt_t)):
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), (l, f)
    assert not [k for layer in net.layers for k in vars(layer)
                if k.endswith("64x32")]


def test_defaults_are_the_reference_signature(ref):
    import inspect
    sig = inspect.signature(EventCompute.__init__)
    sig_r = inspect.signature(ref.compute.EventCompute.__init__)
    assert [(p.name, p.default) for p in sig.parameters.values()] \
        == [(p.name, p.default) for p in sig_r.parameters.values()]
    ec = EventCompute(mode="kernel")
    assert (ec.threshold, ec.bm, ec.bk, ec.bn, ec.gather_bm, ec.delta_mode,
            ec.delta_window) == (0.0, 128, 128, 128, 32, "window", None)
    cpu = torch.device("cpu")
    assert ec._delta_window_size(cpu) == 128
    assert EventCompute(mode="gather")._delta_window_size(cpu) == 32
    assert EventCompute(mode="gather", gather_bm=4)._delta_window_size(
        cpu) == 8
    assert EventCompute(mode="kernel", delta_window=24)._delta_window_size(
        cpu) == 24


def test_option_validation_matches_reference(ref, monkeypatch):
    for kw in (dict(mode="bogus"), dict(delta_mode="scan")):
        with pytest.raises(ValueError) as got:
            EventCompute(**kw)
        with pytest.raises(ValueError) as want:
            ref.compute.EventCompute(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="mode 'pallas'"):
        EventCompute(mode="pallas")         # the port calls it "kernel"
    # kernel mode's window must be a multiple of 8, as the reference's
    rn, pn = sd_nets(ref)
    xs = ref.network.make_inputs(64, 0.3, 40, seed=9)
    with pytest.raises(ValueError, match="multiple of 8"):
        pn.run_batch(torch.from_numpy(xs),
                     compute=EventCompute(mode="kernel", delta_window=12))
    with pytest.raises(ValueError, match="multiple of 8"):
        rn.run_batch(xs, compute=ref.compute.EventCompute(
            mode="pallas", delta_window=12))
    # gather mode takes any window, as the reference's
    assert_matches(ref, (rn, pn), xs, options(ref, "gather",
                                              delta_window=12))
