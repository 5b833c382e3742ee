"""The ssm state neurons' scan (``kernels/neuron_scan``) against the loop it
replaces: on the CPU the wrapper runs the plain version, and on a card the
kernel (``csrc/neuron_scan.cu``), one launch a call, gives the loop's bits.

The card tests skip without one (decided in the ``card`` fixture); run
them there with ``python -m pytest -q --noconftest
tests/test_torch_neuron_scan.py`` (this file imports no JAX)."""

import pytest
import torch

from repro_torch import trace
from repro_torch.kernels.neuron_scan import ops
from repro_torch.neuromorphic import SimLayer, fc_network, make_inputs

#: (T, n): one step, a few, a published stream over ragged and
#: published state widths.
SHAPES = ((1, 333), (7, 4096), (1024, 333))
DECAYS = (0.5, 0.9)


def _loop(pre, x0, decay, force_active):
    """The recurrence as ``SimLayer._neuron_batch`` ran it before the
    scan: T vectorised steps."""
    x = x0
    y = torch.empty_like(pre)
    for t in range(pre.shape[0]):
        x = decay * x + pre[t]
        y[t] = x.abs() + 1.0 if force_active else x
    return y, x


def _bits(a):
    return a.view(torch.int32)


def _same(a, b):
    """The same float32 bits, NaN included."""
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


def _case(T, n, *, seed=0, strided=False, special=False, device="cpu"):
    """Pre-activations (a row slice of a wider block when ``strided``,
    with NaN and inf entries when ``special``) and a nonzero state."""
    g = torch.Generator().manual_seed(seed)
    wide = torch.randn((T, n + (37 if strided else 0)), generator=g)
    if special:
        flat = wide.view(-1)
        idx = torch.randperm(flat.numel(), generator=g)[:12]
        flat[idx[:4]] = float("nan")
        flat[idx[4:8]] = float("inf")
        flat[idx[8:]] = float("-inf")
    x0 = torch.randn(n, generator=g)
    wide, x0 = wide.to(device), x0.to(device)
    return (wide[:, :n] if strided else wide), x0


CASES = [dict(strided=s, special=p) for s in (False, True)
         for p in (False, True)]


@pytest.mark.parametrize("force_active", [False, True])
@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("T,n", SHAPES)
def test_wrapper_equals_the_loop_on_cpu(T, n, decay, force_active):
    for kw in CASES:
        pre, x0 = _case(T, n, **kw)
        assert pre.stride(0) == n + (37 if kw["strided"] else 0)
        keep = x0.clone()
        y, x = ops.ssm_scan(pre, x0, decay, force_active)
        want_y, want_x = _loop(pre, x0, decay, force_active)
        assert _same(y, want_y) and _same(x, want_x), kw
        assert _same(x0, keep)
        if kw["special"]:
            assert torch.isnan(y).any()


def test_cpu_calls_launch_nothing_and_open_no_span():
    before = ops.ssm_scan.launches
    pre, x0 = _case(16, 40)
    with trace.recording() as rec:
        ops.ssm_scan(pre, x0, 0.9, True)
    assert ops.ssm_scan.launches == before
    assert not rec.spans and rec.count("neuron_scan.entries") == 0


def test_rejects_what_the_kernel_does_not_take():
    pre, x0 = _case(4, 8)
    with pytest.raises(ValueError):
        ops.ssm_scan(pre, x0[:7], 0.9, False)
    with pytest.raises(ValueError):
        ops.ssm_scan(pre[0], x0, 0.9, False)
    with pytest.raises(ValueError):
        ops.ssm_scan(pre.to("meta"), x0.to("meta"), 0.9, False)


@pytest.mark.parametrize("force_active", [False, True])
def test_neuron_batch_keeps_the_loop_and_the_state(force_active):
    """``SimLayer._neuron_batch``'s ``ssm`` branch returns the loop's
    messages and final state, and leaves the caller's state as it was."""
    layer = SimLayer(name="s", kind="fc", weights=torch.zeros(5, 333),
                     neuron_model="ssm", decay=0.9,
                     force_active=force_active)
    pre, x0 = _case(64, 333, strided=True, seed=3)
    state = {"x": x0}
    keep = x0.clone()
    y, new = layer._neuron_batch(pre, state)
    want_y, want_x = _loop(pre, x0, 0.9, force_active)
    assert _same(y, want_y) and _same(new["x"], want_x)
    assert state["x"] is x0 and _same(x0, keep)


# ------------------------------------------------------------ on the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


@pytest.mark.parametrize("force_active", [False, True])
@pytest.mark.parametrize("decay", DECAYS)
@pytest.mark.parametrize("T,n", SHAPES + ((1024, 4096), (40, 1)))
def test_kernel_gives_the_loops_bits(card, T, n, decay, force_active):
    """One launch a call; the messages and the final state are the
    loop's on the card bit for bit, the caller's state untouched."""
    for kw in CASES:
        pre, x0 = _case(T, n, device=card, **kw)
        keep = x0.clone()
        before = ops.ssm_scan.launches
        y, x = ops.ssm_scan(pre, x0, decay, force_active)
        assert ops.ssm_scan.launches == before + 1
        want_y, want_x = _loop(pre, x0, decay, force_active)
        torch.cuda.synchronize()
        assert _same(y, want_y) and _same(x, want_x), kw
        assert _same(x0, keep)


@pytest.mark.parametrize("T,n", [(0, 333), (0, 4096), (5, 0)])
def test_kernel_empty_blocks(card, T, n):
    """An empty block is one call: no messages, and the final state a
    new tensor holding ``x0`` (for T = 0, the state the loop returns)."""
    pre, x0 = _case(T, n, device=card)
    before = ops.ssm_scan.launches
    y, x = ops.ssm_scan(pre, x0, 0.9, True)
    torch.cuda.synchronize()
    assert ops.ssm_scan.launches == before + 1
    assert tuple(y.shape) == (T, n) and y.device == pre.device
    assert _same(x, x0)
    if n:
        assert x.data_ptr() != x0.data_ptr()


def test_kernel_rejects_a_strided_column(card):
    """The kernel reads ``pre`` with unit column stride: any other
    layout is refused, not copied."""
    pre, x0 = _case(16, 64, device=card)
    with pytest.raises(ValueError):
        ops.ssm_scan(pre.t().contiguous().t(), x0, 0.9, False)


def test_run_batch_scans_each_state_layer_once_under_its_span(
        card, monkeypatch):
    """A recorded ``run_batch`` over ssm layers launches one scan a
    layer, inside the layer's ``network.neuron`` span, counting T x n
    entries; its outputs and counters are the loop's."""
    net = fc_network([300, 160, 40, 24], weight_density=0.5,
                     neuron_model="ssm", seed=0, device=card)
    xs = make_inputs(300, 0.3, 200, seed=1, device=card)
    before = ops.ssm_scan.launches
    with trace.recording() as rec:
        out, cnts = net.run_batch(xs)
    assert ops.ssm_scan.launches == before + len(net.layers)
    scans = [s for s in rec.spans if s.name == "neuron_scan.launch"]
    assert len(scans) == len(net.layers)
    for s in scans:
        assert rec.spans[s.parent].name == "network.neuron"
    assert rec.count("neuron_scan.entries") == 200 * sum(
        l.n_neurons for l in net.layers)

    orig = SimLayer._neuron_batch

    def loop(self, pre, state):
        if self.neuron_model != "ssm":
            return orig(self, pre, state)
        y, x = _loop(pre, state["x"], self.decay, self.force_active)
        return y, dict(state, x=x)
    monkeypatch.setattr(SimLayer, "_neuron_batch", loop)
    want_out, want_cnts = net.run_batch(xs)
    assert _same(out, want_out)
    for c, w in zip(cnts, want_cnts):
        for f in ("msgs_in", "macs", "fetches_dense", "msgs_out",
                  "acts_evented"):
            assert torch.equal(getattr(c, f), getattr(w, f)), f
