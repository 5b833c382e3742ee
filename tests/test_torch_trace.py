"""The port's in-process tracer (``repro_torch.trace``) on the CPU: off it
keeps nothing and costs one check; on, the simulation path's spans nest
as the work does, share one request id per ``run_batch``, stamp the
profiler's clock and change no output or counter."""

import tracemalloc

import pytest
import torch

from repro_torch import trace
from repro_torch.kernels.event_matmul import ops as em
from repro_torch.neuromorphic import (EventCompute, compile_network,
                                      fc_network, make_inputs)

CPU = dict(device="cpu")
FIELDS = ("msgs_in", "macs", "fetches_dense", "msgs_out", "acts_evented")


def _net(neuron_model="relu", seed=0):
    return fc_network([48, 160, 40, 24], weight_density=0.5,
                      neuron_model=neuron_model, seed=seed, **CPU)


def _xs(steps=20, seed=1):
    return make_inputs(48, 0.3, steps, seed=seed, **CPU)


def _named(rec, name, request=None):
    return [s for s in rec.spans if s.name == name
            and (request is None or s.request == request)]


def test_off_span_is_the_shared_noop_and_reads_nothing(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("touched while no recording is open")
    monkeypatch.setattr(trace, "_clock", boom)
    monkeypatch.setattr(trace, "Span", boom)
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not trace.enabled()
    assert trace.span("network.layer", layer="fc0") is trace._NOOP
    assert trace.request("network.run_batch") is trace._NOOP
    assert trace.count("compute.packs", 1) is None
    # a whole run opens none: every span would have called ``Span``
    _net().run_batch(_xs(), compute=EventCompute(mode="kernel"))


def test_off_span_allocates_nothing():
    def calls(fn, n=20000):
        for _ in range(n):
            with fn("network.layer", layer="fc0"):
                pass

    def const(name, **attrs):
        return trace._NOOP

    peaks = {}
    for fn in (const, trace.span, const, trace.span):
        calls(fn, 100)
        tracemalloc.start()
        calls(fn)
        peaks[fn] = tracemalloc.get_traced_memory()
        tracemalloc.stop()
    # the same footprint as a function that returns a constant
    assert peaks[trace.span] == peaks[const]


def test_run_batch_span_tree_and_request_ids():
    net = _net()
    ec = EventCompute(mode="kernel")
    with trace.recording() as rec:
        net.run_batch(_xs(), compute=ec)
        net.run_batch(_xs(seed=2), compute=ec)
    assert rec.requests == 2
    runs = _named(rec, "network.run_batch")
    assert [s.request for s in runs] == [0, 1]
    assert all(s.parent is None for s in runs)
    for req, run in enumerate(runs):
        layers = _named(rec, "network.layer", req)
        assert [s.attrs["layer"] for s in layers] == ["fc0", "fc1", "fc2"]
        assert all(s.parent == run.index for s in layers)
        for layer in layers:
            kids = [s for s in rec.spans if s.parent == layer.index]
            names = [s.name for s in kids]
            assert names == ["compute.forward", "network.neuron"]
            for s in kids:
                assert s.request == req
                assert layer.start <= s.start <= s.end <= layer.end
        assert run.start <= layers[0].start and layers[-1].end <= run.end


def test_self_time_is_duration_less_children():
    net = _net()
    with trace.recording() as rec:
        net.run_batch(_xs(), compute=EventCompute(mode="kernel"))
    for name in ("network.layer", "network.run_batch", "compute.forward"):
        want = 0.0
        for s in _named(rec, name):
            kids = [c for c in rec.spans if c.parent == s.index]
            want += s.seconds - sum(c.seconds for c in kids)
        assert rec.self_seconds(name) == pytest.approx(want, rel=1e-9,
                                                       abs=1e-12)
    # the layers' self time and their children add up to their total
    children = rec.total("compute.forward") + rec.total("network.neuron")
    assert rec.self_seconds("network.layer") + children == pytest.approx(
        rec.total("network.layer"), rel=1e-9)


def test_total_covers_nesting_and_self_time_its_children():
    """A span inside another of its name counts once in ``total``; self
    time is each span's duration less its direct children's."""
    with trace.recording() as rec:
        with trace.span("compute.forward"):
            with trace.span("event_matmul.bind"):
                pass
            with trace.span("compute.pack"):
                with trace.span("compute.pack"):
                    with trace.span("event_matmul.launch"):
                        pass
    fwd, bind, pack, inner, launch = rec.spans
    assert [s.parent for s in rec.spans] == [None, 0, 0, 2, 3]
    assert rec.self_seconds("compute.forward") == pytest.approx(
        fwd.seconds - bind.seconds - pack.seconds, rel=1e-12)
    assert rec.self_seconds("compute.pack") == pytest.approx(
        pack.seconds - inner.seconds + inner.seconds - launch.seconds,
        rel=1e-12)
    assert rec.total("compute.pack") == pack.seconds     # outermost only
    assert rec.total("compute.forward") == fwd.seconds
    assert rec.total("event_matmul.launch") == launch.seconds


@pytest.mark.parametrize("kw", [{}, dict(threshold=0.3, bm=16, bk=16)],
                         ids=["defaults", "threshold-tiles16"])
def test_a_second_run_packs_nothing(kw):
    net = _net("sd_relu")
    ec = EventCompute(mode="kernel", **kw)
    with trace.recording() as first:
        net.run_batch(_xs(), compute=ec)
    with trace.recording() as second:
        net.run_batch(_xs(), compute=ec)
    assert first.count("compute.packs") > 0
    assert first.total("compute.pack") > 0
    assert second.count("compute.packs") == 0
    assert _named(second, "compute.pack") == []


def test_nested_recording_raises():
    with trace.recording():
        with pytest.raises(RuntimeError):
            with trace.recording():
                pass
    with trace.recording() as rec:                   # closed cleanly
        pass
    assert rec.spans == []


def test_counts_are_summed_at_close_into_their_spans():
    rows = torch.tensor([1, 2, 3])
    with trace.recording() as rec:
        trace.count("n", 2)                          # outside any span
        with trace.request("r"):
            trace.count("n", torch.tensor(5, dtype=torch.int64))
            with trace.span("leaf"):
                trace.count("n", torch.tensor(7, dtype=torch.int64))
                trace.count("n", 1)
                # pairs: the product summed, the second operand broadcast
                trace.count("p", (torch.tensor([[True, False, True]]), rows))
                trace.count("p", (torch.ones(2, 3, dtype=torch.bool), rows))
                trace.count("p", (torch.tensor([2, 0, 1]), rows))
        assert rec._pending                          # nothing summed yet
    assert rec.counts == {"n": 2}
    assert rec.spans[0].counts == {"n": 5}
    assert rec.spans[1].counts == {"n": 8, "p": 4 + 12 + 5}
    assert rec.count("n") == 15
    assert rec.count("n", requests={0}) == 13


@pytest.mark.parametrize("neuron_model", ["relu", "if", "sd_relu"])
@pytest.mark.parametrize("mode", ["kernel", "gather"])
def test_outputs_and_counters_bit_identical_on_and_off(neuron_model, mode):
    net = _net(neuron_model, seed=3)
    xs = _xs(steps=40)
    out_off, cnt_off = net.run_batch(xs, compute=EventCompute(mode=mode))
    with trace.recording() as rec:
        out_on, cnt_on = net.run_batch(xs, compute=EventCompute(mode=mode))
    assert _named(rec, "network.run_batch")
    assert torch.equal(out_on, out_off)
    for a, b in zip(cnt_on, cnt_off):
        for f in FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("neuron_model", ["relu", "ssm"])
def test_run_batch_hands_the_wire_on_and_counts_epilogue_entries(
        neuron_model):
    """A recorded ``run_batch`` hands each layer after the first its
    input's events from the previous layer's epilogue (L - 1 handoffs)
    and counts T x n epilogue entries a layer; two runs count twice."""
    net = _net(neuron_model)
    xs = _xs(steps=30)
    with trace.recording() as rec:
        net.run_batch(xs, compute=EventCompute(mode="kernel"))
        net.run_batch(xs, compute="dense")
    L = len(net.layers)
    assert rec.count("network.wire_handoffs") == 2 * (L - 1)
    assert rec.count("network.wire_handoffs", requests={1}) == L - 1
    assert rec.count("neuron_epilogue.entries") == 2 * 30 * sum(
        l.n_neurons for l in net.layers)
    # counted inside the layers, not beside them
    assert "network.wire_handoffs" not in rec.counts


def test_compile_network_spans():
    with trace.recording() as rec:
        compiled = compile_network("whisper-base", seed=0, **CPU)
    spans = _named(rec, "frontend.draw")
    assert [s.attrs["layer"] for s in spans] == [
        l.name for l in compiled.net.layers]
    assert all(s.parent is None for s in spans)
    assert len(rec.spans) == len(spans)              # the draws alone
    assert rec.total("frontend.draw") > 0


def test_span_starts_lie_on_the_profilers_clock():
    """Under a profiler each span opens a ``record_function`` range of its
    name, and the two start within 2 ms of each other."""
    from torch.profiler import ProfilerActivity, profile
    net = _net("sd_relu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.recording() as rec:
            net.run_batch(_xs(), compute=EventCompute(mode="kernel"))
    ranges: dict[str, list[int]] = {}
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            ranges.setdefault(e.name(), []).append(int(e.start_ns()))
    by_name: dict[str, list] = {}
    for s in rec.spans:
        by_name.setdefault(s.name, []).append(s)
    assert {"network.run_batch", "network.layer", "network.neuron",
            "compute.forward", "compute.pack"} <= set(by_name)
    for name, spans in by_name.items():
        starts = sorted(ranges[name])
        assert len(starts) == len(spans), name
        for s, t in zip(spans, starts):
            assert abs(s.start - t) < 2_000_000, (name, s.start - t)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_live_tiles_equal_the_joint_compaction(seed):
    """The pair ``_launch`` counts, the activity map and the weights'
    ``occ_rows()``, sums to the joint compaction's live triples."""
    g = torch.Generator().manual_seed(seed)
    mb, kb, nb = 5, 7, 11
    t = em.KERNEL_TILE
    kw = em.KernelWeights(torch.zeros(kb * t, nb * t))
    full = em.KernelWeights(torch.zeros(kb * t, nb * t))
    occ = torch.rand((kb, nb), generator=g) < 0.6
    kw.occ = occ.to(torch.uint8)
    full.occ = torch.ones_like(kw.occ)
    maps = [torch.rand((mb, kb), generator=g) < 0.4 for _ in range(3)]
    with trace.recording() as rec:
        for active in maps:
            trace.count("live", (active, kw.occ_rows()))
        trace.count("all", (torch.ones_like(maps[0]), full.occ_rows()))
    assert kw.occ_rows().dtype == torch.int64
    assert rec.count("live") == sum(
        int(em._compact_indices_joint(a, occ)[1].sum()) for a in maps)
    assert rec.count("all") == mb * nb * kb


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: torch.cuda.is_available() is False")
    return torch.device("cuda")


def test_cuda_run_batch_binds_and_counts_live_tiles(card):
    """On a card a recorded ``run_batch`` yields the wrapper's
    ``event_matmul.bind`` and ``event_matmul.launch`` spans, one of each
    a layer (its two products share one library call), and live tiles
    equal to the joint compaction's over both products of every layer."""
    net = fc_network([300, 160, 40, 24], weight_density=0.5, seed=0,
                     device=card)
    xs = make_inputs(300, 0.3, 200, seed=1, device=card)
    calls = []

    class Keep(EventCompute):
        def forward(self, layer, x_eff, act_mask, msgs_in):
            calls.append((layer, x_eff, act_mask))
            return super().forward(layer, x_eff, act_mask, msgs_in)

    with trace.recording() as rec:
        net.run_batch(xs, compute=Keep(mode="kernel"))
    n = len(net.layers)
    assert len(_named(rec, "event_matmul.bind")) == n
    assert len(_named(rec, "event_matmul.launch")) == n
    want = 0
    for layer, x, m in calls:
        occ = em.weight_block_occupancy(layer.weights).cpu()
        for a in (x, (m != 0).to(torch.int8)):
            active = em.block_activity(a.cpu(), 0.0)
            want += int(em._compact_indices_joint(active, occ)[1].sum())
    assert len(calls) == n and rec.count("event_matmul2.live_tiles") == want


def test_cuda_run_batch_launches_one_epilogue_a_layer(card):
    """On a card a recorded ``run_batch`` opens one
    ``neuron_epilogue.launch`` span a layer, inside its
    ``network.neuron``, and counts L - 1 handoffs."""
    net = fc_network([300, 160, 40, 24], weight_density=0.5, seed=0,
                     device=card)
    xs = make_inputs(300, 0.3, 200, seed=1, device=card)
    with trace.recording() as rec:
        net.run_batch(xs, compute=EventCompute(mode="kernel"))
    layers = _named(rec, "network.layer")
    launches = _named(rec, "neuron_epilogue.launch")
    assert len(launches) == len(layers) == len(net.layers)
    for s, layer in zip(launches, layers):
        neuron = rec.spans[s.parent]
        assert neuron.name == "network.neuron"
        assert neuron.parent == layer.index
    assert rec.count("network.wire_handoffs") == len(net.layers) - 1
    assert rec.count("neuron_epilogue.entries") == 200 * (160 + 40 + 24)
