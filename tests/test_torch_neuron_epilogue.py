"""A layer's neuron epilogue (``kernels/neuron_epilogue``) against the eager
glue it replaces, and the wire handoff between layers: on the CPU the
wrapper runs the plain version, and on a card the kernel
(``csrc/neuron_epilogue.cu``), one launch a layer, gives its bits.

The card tests skip without one (decided in the ``card`` fixture); run
them there with ``python -m pytest -q --noconftest
tests/test_torch_neuron_epilogue.py`` (this file imports no JAX)."""

import numpy as np
import pytest
import torch

from repro_torch import trace
from repro_torch.kernels.neuron_epilogue import ops
from repro_torch.kernels.neuron_epilogue.ref import (FORCE_ACTIVE, IDENTITY,
                                                     RELU,
                                                     neuron_epilogue_ref)
from repro_torch.neuromorphic import (EventCompute, SimLayer, fc_network,
                                      make_inputs, network_from_numpy,
                                      programmed_fc_network)
from repro_torch.neuromorphic.network import Wire

CPU = dict(device="cpu")
FIELDS = ("msgs_in", "macs", "fetches_dense", "msgs_out", "acts_evented")
CODES = {"identity": IDENTITY, "relu": RELU, "force_active": FORCE_ACTIVE}
OPTIONS = [dict(bias=b, gate=g) for b in (False, True) for g in (False, True)]


def _glue(pre, macs, bias, gate, code):
    """The eager glue ``SimLayer.step_batch`` ran before the epilogue: the
    bias, the neuron, the gate, ``msgs_out`` and ``acts_evented``, and the
    next layer's wire mask and ``msgs_in`` recomputed from ``y_msgs``."""
    if bias is not None:
        pre = pre + bias
    if code == RELU:
        y = torch.clamp_min(pre, 0.0)
    elif code == FORCE_ACTIVE:
        y = pre.abs() + 1.0
    else:
        y = pre
    if gate is not None:
        y = y * gate
    msgs_out = (y != 0).to(torch.float32)
    act_mask = (y.to(torch.float32) != 0).to(torch.float32)
    msgs_in = act_mask.sum(dim=1)
    return (y, msgs_out, (macs > 0).to(torch.float32), msgs_in,
            msgs_in.to(torch.float64))


def _bits(a):
    return a.view({8: torch.int64, 4: torch.int32}[a.element_size()])


def _same(a, b):
    """The same bits, NaN and signed zeros included."""
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(_bits(a.contiguous()), _bits(b.contiguous())))


def _case(T, n, *, seed=0, strided=False, special=False, bias=False,
          gate=False, device="cpu"):
    """(pre, macs, bias, gate): ``pre`` a row slice of a wider block when
    ``strided``; with ``special`` NaN, +-inf, -0.0 and subnormal entries in
    ``pre`` and the bias, and a NaN in ``macs``; the gate 0/1 with a few
    fractional entries, so an inf meets a zero gate."""
    g = torch.Generator().manual_seed(seed)
    wide = torch.randn((T, n + (37 if strided else 0)), generator=g)
    macs = torch.randint(0, 3, (T, n), generator=g).to(torch.float32)
    b = torch.randn(n, generator=g) if bias else None
    gt = ((torch.rand(n, generator=g) < 0.6).to(torch.float32)
          if gate else None)
    if special:
        idx = torch.randperm(T * n, generator=g)[:20]
        rows, cols = idx // n, idx % n
        vals = [float("nan"), float("inf"), float("-inf"), -0.0, 0.0,
                1e-40, -1e-40, -1.0]
        for i, (r, c) in enumerate(zip(rows.tolist(), cols.tolist())):
            wide[r, c] = vals[i % len(vals)]
        macs.view(-1)[idx[0]] = float("nan")
        if b is not None:
            b[:4] = torch.tensor([-0.0, float("nan"), 1e-40, float("-inf")])
        if gt is not None:
            gt[4:6] = 0.5
    pre = wide[:, :n] if strided else wide
    to = lambda t: None if t is None else t.to(device)
    return to(pre), to(macs), to(b), to(gt)


CASES = [dict(strided=s, special=p) for s in (False, True)
         for p in (False, True)]


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize("opts", OPTIONS,
                         ids=lambda o: f"bias{int(o['bias'])}"
                                       f"-gate{int(o['gate'])}")
@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"strided{int(c['strided'])}"
                                       f"-special{int(c['special'])}")
@pytest.mark.parametrize("code", CODES.values(), ids=CODES.keys())
def test_ref_is_the_eager_glue(code, case, opts):
    """The plain version gives the eager glue's bits on every map and
    both counts, NaN, +-inf, -0.0 and subnormals included, and the
    wrapper on CPU tensors is the plain version."""
    pre, macs, bias, gate = _case(9, 70, seed=code, **case, **opts)
    want = _glue(pre, macs, bias, gate, code)
    got = neuron_epilogue_ref(pre, macs, bias, gate, code)
    for w, a in zip(want, got):
        assert _same(w, a)
    for w, a in zip(want, ops.neuron_epilogue(pre, macs, bias, gate, code)):
        assert _same(w, a)
    if code == IDENTITY and bias is None and gate is None:
        assert got[0] is pre


def test_wrapper_counts_entries_and_checks_shapes():
    pre, macs, _, _ = _case(5, 33)
    with trace.recording() as rec:
        ops.neuron_epilogue(pre, macs, None, None, RELU)
        ops.neuron_epilogue(pre[:2], macs[:2], None, None, IDENTITY)
    assert rec.count("neuron_epilogue.entries") == 7 * 33
    with pytest.raises(ValueError):
        ops.neuron_epilogue(pre, macs[:, :-1], None, None, RELU)
    with pytest.raises(ValueError):
        ops.neuron_epilogue(pre, macs, None, None, 3)
    for vec in (torch.ones(5, 33), torch.ones(33, 1), torch.ones(32)):
        with pytest.raises(ValueError):
            ops.neuron_epilogue(pre, macs, vec, None, RELU)
        with pytest.raises(ValueError):
            ops.neuron_epilogue(pre, macs, None, vec, RELU)


#: Thresholds away from float roundoff of zero: the step-major engine's
#: products (M = 1) round otherwise than the batch's, and a sigma-delta
#: quantiser at 1e-9 would turn that roundoff into messages.
THRESHOLDS = {"if": 0.6, "sd_relu": 0.03}


def _conv_specs(seed=0, neuron_model="relu", sends_deltas=False):
    """conv -> conv -> fc on an 8x8x2 input, as field mappings."""
    rng = np.random.default_rng(seed)
    specs, h, c_prev = [], 8, 2
    for i, c in enumerate((4, 8)):
        wgt = rng.normal(0, 1 / 3.0, (3, 3, c_prev, c)).astype(np.float32)
        wgt *= rng.random(wgt.shape) < 0.6
        specs.append(dict(name=f"conv{i}", kind="conv", weights=wgt,
                          stride=2, in_hw=(h, h), neuron_model=neuron_model,
                          sends_deltas=sends_deltas,
                          threshold=THRESHOLDS.get(neuron_model, 0.0),
                          bias=rng.normal(0, 0.1, c * (h // 2) ** 2)
                          .astype(np.float32)))
        h, c_prev = h // 2, c
    specs.append(dict(name="fc", kind="fc",
                      weights=rng.normal(0, 0.3, (h * h * c_prev, 10))
                      .astype(np.float32)))
    return specs


def _nets(device="cpu"):
    """Networks over every neuron path: fc stacks of each neuron model,
    a characterization stack (force-active, gated), a biased conv stack
    and a sigma-delta conv chain."""
    def fc(model):
        def build():
            net = fc_network([48, 96, 40, 24], weight_density=0.5,
                             neuron_model=model, seed=3, device=device)
            for layer in net.layers:
                layer.threshold = THRESHOLDS.get(model, 0.0)
            return net, make_inputs(48, 0.3, 20, seed=1, device=device)
        return build

    def programmed():
        return (programmed_fc_network([48, 96, 40, 24],
                                      weight_densities=[0.5, 0.7, 1.0],
                                      act_densities=[0.4, 0.6, 1.0], seed=4,
                                      device=device),
                make_inputs(48, 0.3, 20, seed=2, device=device))

    def conv(model, sd):
        return lambda: (network_from_numpy(_conv_specs(5, model, sd), 128,
                                           device=device),
                        make_inputs(128, 0.3, 12, seed=6, device=device))
    return {"relu": fc("relu"), "if": fc("if"), "sd_relu": fc("sd_relu"),
            "ssm": fc("ssm"), "programmed": programmed,
            "conv": conv("relu", False), "conv_sd": conv("sd_relu", True)}


NETS = tuple(_nets())
COMPUTES = {"dense": lambda: "dense",
            "gather": lambda: EventCompute(mode="gather"),
            "kernel": lambda: EventCompute(mode="kernel")}


def _no_handoff(net, xs, cc):
    """``run_batch`` as it ran before the handoff: each layer's
    ``step_batch`` recomputes its wire events from its input."""
    states, accs = net.init_states(), net.init_accs()
    cur, cnts = xs, []
    for i, layer in enumerate(net.layers):
        cur, states[i], c, accs[i] = layer.step_batch(cur, states[i],
                                                      accs[i], compute=cc)
        cnts.append(c)
    return cur.reshape(xs.shape[0], -1), cnts


def _assert_runs_equal(a, b, steps=False):
    """Outputs and all five counters bit for bit; against the step-major
    engine (``steps``: one list of counters a layer) the outputs to
    float roundoff only, as its products run at M = 1."""
    out_a, cnt_a = a
    out_b, cnt_b = b
    if steps:
        torch.testing.assert_close(out_a, out_b, rtol=1e-5, atol=1e-6)
    else:
        assert _same(out_a, out_b)
    for ca, cb in zip(cnt_a, cnt_b, strict=True):
        for f in FIELDS:
            va = getattr(ca, f)
            vb = (torch.stack([getattr(s, f) for s in cb]) if steps
                  else getattr(cb, f))
            assert _same(va, vb), f


@pytest.mark.parametrize("compute", COMPUTES)
@pytest.mark.parametrize("net", NETS)
def test_handoff_matches_step_major_and_no_handoff(net, compute):
    """``run_batch`` with the handoff gives the bits of ``step_batch``
    called without it (outputs and all five counters) and the step-major
    ``run``'s counters."""
    network, xs = _nets()[net]()
    cc = COMPUTES[compute]()
    got = network.run_batch(xs, compute=cc)
    _assert_runs_equal(got, _no_handoff(network, xs, cc))
    out_s, steps = network.run(xs, compute=cc)
    per_layer = list(zip(*steps))
    _assert_runs_equal(got, (out_s, per_layer), steps=True)


@pytest.mark.parametrize("net", ("relu", "programmed", "conv", "conv_sd"))
def test_kept_msgs_out_survives_the_next_layer(net):
    """The handed-on mask is the kept ``msgs_out``: the next layer's
    compute call gets that very tensor, and once every layer has run
    each kept map still holds what its layer wrote."""
    network, xs = _nets()[net]()
    seen = []

    class Keep(EventCompute):
        def forward(self, layer, x_eff, act_mask, msgs_in):
            seen.append(act_mask)
            return super().forward(layer, x_eff, act_mask, msgs_in)

    states, accs = network.init_states(), network.init_accs()
    cur, wire, kept, cnts = xs, None, [], []
    for i, layer in enumerate(network.layers):
        cur, states[i], c, accs[i], wire = layer._step_batch(
            cur, states[i], accs[i], compute=Keep(mode="kernel"), wire=wire)
        kept.append(c.msgs_out.clone())
        cnts.append(c)
    for i, c in enumerate(cnts):
        assert _same(c.msgs_out, kept[i])
        if i + 1 < len(cnts):
            assert seen[i + 1] is c.msgs_out
    assert wire.mask is cnts[-1].msgs_out


def test_step_batch_rejects_a_wire_of_another_shape():
    network, xs = _nets()["relu"]()
    layer = network.layers[1]
    mask = torch.zeros((xs.shape[0], 5))
    with pytest.raises(ValueError):
        layer._step_batch(torch.zeros((xs.shape[0], 96)),
                          layer.init_state(), None,
                          wire=Wire(mask, mask.sum(1),
                                    mask.sum(1).double()))


# ------------------------------------------------------------------ card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def _card_matches_plain(pre, macs, bias, gate, code):
    before = ops.neuron_epilogue.launches
    got = ops.neuron_epilogue(pre, macs, bias, gate, code)
    assert ops.neuron_epilogue.launches == before + 1
    want = neuron_epilogue_ref(pre, macs, bias, gate, code)
    for w, a in zip(want, got):
        assert _same(w, a)
    if code == IDENTITY and bias is None and gate is None:
        assert got[0] is pre


@pytest.mark.parametrize("opts", OPTIONS,
                         ids=lambda o: f"bias{int(o['bias'])}"
                                       f"-gate{int(o['gate'])}")
@pytest.mark.parametrize("case", CASES,
                         ids=lambda c: f"strided{int(c['strided'])}"
                                       f"-special{int(c['special'])}")
@pytest.mark.parametrize("code", CODES.values(), ids=CODES.keys())
def test_card_kernel_is_the_plain_version(card, code, case, opts):
    """One launch gives the plain version's bits on the card (eager
    PyTorch there), special values and a strided ``pre`` included."""
    _card_matches_plain(*_case(9, 70, seed=code, device=card, **case,
                               **opts), code)


#: (T, n): one step (column chunks), a ragged width, and the cells'
#: widths: mamba2's 8,512 and 4,096 at T = 1,024, its 50,277-wide head,
#: whisper's 2,048 at T = 448.
CARD_SHAPES = ((1, 50_277), (1, 333), (3, 1_000), (200, 1_029),
               (448, 2_048), (1024, 8_512), (1024, 4_096), (1024, 50_277))


@pytest.mark.parametrize("shape", CARD_SHAPES, ids=str)
def test_card_kernel_at_the_cells_widths(card, shape):
    T, n = shape
    for code in CODES.values():
        pre, macs, bias, gate = _case(T, n, seed=T + code, strided=True,
                                      special=True, device=card)
        _card_matches_plain(pre, macs, None, None, code)
    _card_matches_plain(pre, macs, bias, gate, RELU)


def test_card_run_batch_launches_one_epilogue_a_layer(card):
    """A recorded ``run_batch`` launches one epilogue a layer, each under
    its layer's ``network.neuron`` span, hands the wire on L - 1 times
    and gives the outputs and counters of the plain path."""
    for net in NETS:
        network, xs = _nets(card)[net]()
        before = ops.neuron_epilogue.launches
        with trace.recording() as rec:
            got = network.run_batch(xs, compute=EventCompute(mode="kernel"))
        n = len(network.layers)
        assert ops.neuron_epilogue.launches == before + n
        spans = [s for s in rec.spans if s.name == "neuron_epilogue.launch"]
        assert len(spans) == n
        assert all(rec.spans[s.parent].name == "network.neuron"
                   for s in spans)
        assert rec.count("network.wire_handoffs") == n - 1
        assert rec.count("neuron_epilogue.entries") == xs.shape[0] * sum(
            l.n_neurons for l in network.layers)
        want = _no_handoff_plain(network, xs)
        _assert_runs_equal(got, want)


def _no_handoff_plain(network, xs):
    """The parent's path on the card: no handoff, and the eager glue."""
    import repro_torch.neuromorphic.network as network_mod
    kept = network_mod.neuron_epilogue
    network_mod.neuron_epilogue = neuron_epilogue_ref
    try:
        return _no_handoff(network, xs, EventCompute(mode="kernel"))
    finally:
        network_mod.neuron_epilogue = kept


def test_card_layer_step_batch_alone_is_unchanged(card):
    """A direct ``SimLayer.step_batch`` (no wire) computes its own wire
    events and launches one epilogue."""
    network, xs = _nets(card)["programmed"]()
    layer: SimLayer = network.layers[0]
    before = ops.neuron_epilogue.launches
    y, _, c, _ = layer.step_batch(xs, layer.init_state(), None,
                                  compute=EventCompute(mode="kernel"))
    assert ops.neuron_epilogue.launches == before + 1
    assert _same(c.msgs_out, (y != 0).to(torch.float32))
    assert _same(c.msgs_in, (xs != 0).to(torch.float32).sum(1).double())
