"""The port's functional network against the JAX package's, on the CPU.

Both packages build networks from the same numpy RNG calls, so a seed
gives bit-identical weights; the JAX side runs its kernel mode as its own
tests do (Pallas in interpret mode) and the port's kernel mode runs the
kernels' plain versions on CPU tensors.  Integer event counters must be
bit-identical; pre-activations and outputs agree to rtol 1e-6 (atol 1e-6
floor: contraction order differs between the two BLAS paths).
"""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from _repro_reference import reference
from repro_torch.neuromorphic import (EventCompute, SimLayer, SimNetwork,
                                      compile_network, fc_network,
                                      get_compute, make_inputs,
                                      network_from_numpy,
                                      programmed_fc_network)
from repro_torch.neuromorphic.compute import DenseCompute, _im2col
from repro_torch.neuromorphic.network import _exact_density_mask

FLOAT_TOL = dict(rtol=1e-6, atol=1e-6)
FIELDS = ("msgs_in", "macs", "fetches_dense", "msgs_out", "acts_evented")
GOLDEN = pathlib.Path(__file__).parent / "golden"
CPU = dict(device="cpu")


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _computes(ref, kind):
    """(reference backend, port backend) pairs by name."""
    return {
        "dense": ("dense", "dense"),
        "gather": (ref.compute.EventCompute(mode="gather"),
                   EventCompute(mode="gather")),
        "kernel": (ref.compute.EventCompute(mode="pallas"),
                   EventCompute(mode="kernel")),
    }[kind]


def _export(net) -> list[dict]:
    """A reference network's layers as plain field mappings."""
    return [{f.name: getattr(l, f.name) for f in dataclasses.fields(l)}
            for l in net.layers]


def conv_specs(seed=0, neuron_model="relu", sends_deltas=False,
               threshold=0.0, weight_density=0.6):
    """conv -> conv -> fc stack on an 8x8x2 input (the reference suites'
    ``conv_stack``), as field mappings."""
    rng = np.random.default_rng(seed)
    specs, h, w, c_prev = [], 8, 8, 2
    for i, c in enumerate((4, 8)):
        wgt = rng.normal(0, 1 / 3.0, (3, 3, c_prev, c)).astype(np.float32)
        wgt *= _exact_density_mask(wgt.shape, weight_density, rng)
        specs.append(dict(name=f"conv{i}", kind="conv", weights=wgt,
                          stride=2, in_hw=(h, w), neuron_model=neuron_model,
                          threshold=threshold, sends_deltas=sends_deltas))
        h, w, c_prev = h // 2, w // 2, c
    wfc = rng.normal(0, 0.3, (h * w * c_prev, 10)).astype(np.float32)
    specs.append(dict(name="fc", kind="fc", weights=wfc,
                      neuron_model="relu"))
    return specs


def assert_runs_match(ref_net, port_net, xs, rc, pc):
    out_r, cnt_r = ref_net.run_batch(xs, compute=rc)
    out_p, cnt_p = port_net.run_batch(torch.from_numpy(xs), compute=pc)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(out_r), **FLOAT_TOL)
    for l, (a, b) in enumerate(zip(cnt_r, cnt_p)):
        for f in FIELDS:
            assert np.array_equal(np.asarray(getattr(a, f)),
                                  getattr(b, f).numpy()), (l, f)
        assert b.msgs_in.dtype == torch.float64
        assert b.macs.dtype == torch.float32
    return out_p, cnt_p


# ---------------------------------------------------------------- builders

def test_builders_bit_identical(ref):
    rn = ref.network.fc_network([48, 64, 32], weight_density=[0.5, 0.7],
                                seed=3)
    pn = fc_network([48, 64, 32], weight_density=[0.5, 0.7], seed=3, **CPU)
    for a, b in zip(rn.layers, pn.layers):
        assert np.array_equal(a.weights, b.weights.numpy())
    rp = ref.network.programmed_fc_network(
        [40, 64, 48], weight_densities=[0.7, 0.7], act_densities=[0.1, 0.2],
        seed=2)
    pp = programmed_fc_network([40, 64, 48], weight_densities=[0.7, 0.7],
                               act_densities=[0.1, 0.2], seed=2, **CPU)
    for a, b in zip(rp.layers, pp.layers):
        assert np.array_equal(a.weights, b.weights.numpy())
        assert np.array_equal(a.msg_gate, b.msg_gate.numpy())
        assert b.force_active
    for dens in (0.0, 0.3, 1.0):
        assert np.array_equal(ref.network.make_inputs(40, dens, 7, seed=5),
                              make_inputs(40, dens, 7, seed=5, **CPU).numpy())


def test_network_from_numpy_round_trip(ref):
    specs = conv_specs(seed=4)
    rn = ref.network.SimNetwork([ref.network.SimLayer(**s) for s in specs],
                                128)
    pn = network_from_numpy(_export(rn), rn.in_size, **CPU)
    for a, b in zip(rn.layers, pn.layers):
        assert np.array_equal(a.weights, b.weights.numpy())
        assert (a.n_neurons, a.fanin, a.n_weights, a.weights_per_core(3)) \
            == (b.n_neurons, b.fanin, b.n_weights, b.weights_per_core(3))
        assert a.w_nnz == b.w_nnz
    with pytest.raises(ValueError):
        network_from_numpy([dict(specs[0], colour="red")], 128, **CPU)


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        fc_network([8, 4])
    with pytest.raises(RuntimeError, match="cuda"):
        make_inputs(8, 0.5, 2)
    with pytest.raises(RuntimeError, match="cuda"):
        network_from_numpy(conv_specs(), 128)
    net = fc_network([8, 4], **CPU)
    with pytest.raises(RuntimeError, match="cuda"):
        net.to("cuda")


# ------------------------------------------------------ functional parity

@pytest.mark.parametrize("compute", ["dense", "gather", "kernel"])
@pytest.mark.parametrize("model,thr", [("relu", 0.0), ("if", 0.5),
                                       ("sd_relu", 0.05), ("ssm", 0.0)])
def test_fc_run_batch_matches_reference(ref, compute, model, thr):
    rn = ref.network.fc_network([48, 64, 32], weight_density=0.6,
                                neuron_model=model, seed=0)
    pn = network_from_numpy(_export(rn), rn.in_size, **CPU)
    for a, b in zip(rn.layers, pn.layers):
        a.threshold = b.threshold = thr
    xs = ref.network.make_inputs(48, 0.3, 12, seed=1)
    assert_runs_match(rn, pn, xs, *_computes(ref, compute))


@pytest.mark.parametrize("compute", ["dense", "gather", "kernel"])
def test_windowed_sigma_delta_chain_matches_reference(ref, compute):
    """T beyond the delta window (gather 32, kernel 128) engages the
    windowed reconstruction, ragged against the window."""
    rn = ref.network.fc_network([64, 96, 96, 32], weight_density=0.8,
                                neuron_model="sd_relu", seed=5)
    pn = network_from_numpy(_export(rn), rn.in_size, **CPU)
    for a, b in zip(rn.layers, pn.layers):
        a.threshold = b.threshold = 0.05
        a.sends_deltas = b.sends_deltas = True
    xs = ref.network.make_inputs(64, 0.4, 200, seed=6)
    assert_runs_match(rn, pn, xs, *_computes(ref, compute))


class _CountingEvent(EventCompute):
    """Kernel-mode event backend that records the rows of every synaptic
    forward (values and counters) and of every value-only pass."""

    def __init__(self):
        super().__init__(mode="kernel")
        self.forward_rows, self.value_rows = [], []

    def forward(self, layer, x_eff, act_mask, msgs_in):
        self.forward_rows.append(x_eff.shape[0])
        return super().forward(layer, x_eff, act_mask, msgs_in)

    def value_forward(self, layer, x_eff):
        self.value_rows.append(x_eff.shape[0])
        return super().value_forward(layer, x_eff)


@pytest.mark.parametrize("kind", ["fc", "conv"])
def test_delta_base_rows_are_value_only(ref, kind):
    """Beyond the delta window the base rows take a value-only pass (no
    counter product) and the run still reproduces the reference's
    counters and outputs; one delta layer's pre-activations agree with the
    reference's windowed ``delta_forward`` at rtol 1e-6."""
    if kind == "fc":
        rn = ref.network.fc_network([64, 96, 96, 32], weight_density=0.8,
                                    neuron_model="sd_relu", seed=7)
        T = 300
    else:
        rn = ref.network.SimNetwork(
            [ref.network.SimLayer(**s) for s in conv_specs(
                seed=3, neuron_model="sd_relu", sends_deltas=True,
                threshold=0.05)], 128)
        T = 200
    pn = network_from_numpy(_export(rn), rn.in_size, **CPU)
    for a, b in zip(rn.layers, pn.layers):
        if kind == "fc":
            a.threshold = b.threshold = 0.05
            a.sends_deltas = b.sends_deltas = True
    xs = ref.network.make_inputs(rn.in_size, 0.4, T, seed=8)
    pc = _CountingEvent()
    assert_runs_match(rn, pn, xs, ref.compute.EventCompute(mode="pallas"),
                      pc)
    n_delta = sum(l.sends_deltas for l in pn.layers[:-1])
    assert n_delta >= 2
    assert pc.value_rows == [-(-T // 128)] * n_delta
    assert pc.forward_rows == [T] * len(pn.layers)
    rng = np.random.default_rng(9)
    layer_r, layer_p = rn.layers[1], pn.layers[1]
    n_in = layer_p.fanin if kind == "fc" else layer_p.weights.shape[2] * \
        layer_p.in_hw[0] * layer_p.in_hw[1]
    x_in = (rng.normal(0, 0.1, (T, n_in))
            * (rng.random((T, n_in)) < 0.2)).astype(np.float32)
    mask = (x_in != 0).astype(np.float32)
    msgs = mask.sum(axis=1)
    acc = rng.normal(0, 1, n_in).astype(np.float32)
    pre_r, macs_r, _, acc_r = ref.compute.EventCompute(
        mode="pallas").delta_forward(layer_r, x_in, acc, mask, msgs)
    pre_p, macs_p, _, acc_p = pc.delta_forward(
        layer_p, torch.from_numpy(x_in), torch.from_numpy(acc),
        torch.from_numpy(mask), torch.from_numpy(msgs))
    np.testing.assert_allclose(pre_p.numpy(), np.asarray(pre_r),
                               **FLOAT_TOL)
    assert np.array_equal(macs_p.numpy(), np.asarray(macs_r))
    np.testing.assert_allclose(acc_p.numpy(), np.asarray(acc_r),
                               **FLOAT_TOL)


def test_programmed_gates_match_reference(ref):
    rn = ref.network.programmed_fc_network(
        [40, 64, 48], weight_densities=[0.7, 0.7], act_densities=[0.1, 0.2],
        seed=2)
    pn = network_from_numpy(_export(rn), rn.in_size, **CPU)
    xs = ref.network.make_inputs(40, 0.2, 10, seed=3)
    for kind in ("dense", "gather", "kernel"):
        assert_runs_match(rn, pn, xs, *_computes(ref, kind))


@pytest.mark.parametrize("compute", ["dense", "gather", "kernel"])
@pytest.mark.parametrize("model,sd,thr", [("relu", False, 0.0),
                                          ("sd_relu", True, 0.05)])
def test_conv_stack_matches_reference(ref, compute, model, sd, thr):
    specs = conv_specs(seed=1, neuron_model=model, sends_deltas=sd,
                       threshold=thr)
    rn = ref.network.SimNetwork([ref.network.SimLayer(**s) for s in specs],
                                128)
    pn = network_from_numpy(specs, 128, **CPU)
    xs = ref.network.make_inputs(128, 0.3, 40, seed=4)
    assert_runs_match(rn, pn, xs, *_computes(ref, compute))


@pytest.mark.parametrize("h,w,stride", [(8, 8, 2), (9, 7, 1), (6, 10, 2)])
def test_im2col_matches_reference(ref, h, w, stride):
    rng = np.random.default_rng(h * 10 + w + stride)
    x4 = rng.normal(0, 1, (2, 3, h, w)).astype(np.float32)
    oh, ow = h // stride, w // stride
    assert np.array_equal(
        ref.compute._im2col(x4, 3, 3, stride, oh, ow),
        _im2col(torch.from_numpy(x4), 3, 3, stride, oh, ow).numpy())
    wgt = rng.normal(0, 0.3, (3, 3, 3, 5)).astype(np.float32)
    rn = ref.network.SimNetwork([ref.network.SimLayer(
        name="c", kind="conv", weights=wgt, stride=stride, in_hw=(h, w))],
        h * w * 3)
    pn = network_from_numpy(_export(rn), rn.in_size, **CPU)
    xs = ref.network.make_inputs(rn.in_size, 0.4, 3, seed=0)
    for kind in ("dense", "gather", "kernel"):
        assert_runs_match(rn, pn, xs, *_computes(ref, kind))


# ----------------------------------------------------- within the port

@pytest.mark.parametrize("model,thr", [("relu", 0.0), ("if", 0.6),
                                       ("sd_relu", 0.03), ("ssm", 0.0)])
def test_step_and_batch_engines_bit_exact(model, thr):
    net = fc_network([48, 64, 32], weight_density=0.5, neuron_model=model,
                     seed=3, **CPU)
    for l in net.layers:
        l.threshold = thr
        l.sends_deltas = model == "sd_relu"
    xs = make_inputs(48, 0.5, 6, seed=4, **CPU)
    out_s, ref_c = net.run(xs)
    out_b, bat_c = net.run_batch(xs)
    np.testing.assert_allclose(out_b.numpy(), out_s.numpy(), rtol=1e-5,
                               atol=1e-6)
    for l, bc in enumerate(bat_c):
        for t in range(xs.shape[0]):
            cm, sv = ref_c[t][l], bc.step_view(t)
            for f in FIELDS:
                assert torch.equal(getattr(cm, f), getattr(sv, f)), (l, t, f)


def test_event_modes_agree_within_port():
    net = network_from_numpy(conv_specs(seed=2), 128, **CPU)
    xs = make_inputs(128, 0.3, 6, seed=2, **CPU)
    out_d, cnt_d = net.run_batch(xs, compute="dense")
    for cc in (EventCompute(mode="gather"), EventCompute(mode="kernel"),
               get_compute("event")):
        out_e, cnt_e = net.run_batch(xs, compute=cc)
        np.testing.assert_allclose(out_e.numpy(), out_d.numpy(), **FLOAT_TOL)
        for a, b in zip(cnt_d, cnt_e):
            for f in FIELDS:
                assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_derived_caches_follow_rebound_weights():
    net = fc_network([16, 24], weight_density=1.0, seed=0, **CPU)
    layer = net.layers[0]
    assert float(layer.w_mask.sum()) == 16 * 24
    w = layer.weights.clone()
    w[:8] = 0.0
    layer.weights = w
    assert float(layer.w_mask.sum()) == 8 * 24
    assert layer.w_nnz == 8 * 24
    xs = make_inputs(16, 1.0, 2, seed=0, **CPU)
    _, cnt = net.run_batch(xs, compute=EventCompute(mode="kernel"))
    _, cnt_d = net.run_batch(xs, compute=DenseCompute())
    assert torch.equal(cnt[0].macs, cnt_d[0].macs)


def test_registry_round_trip():
    from repro_torch.neuromorphic import compute as C
    assert isinstance(get_compute("dense"), DenseCompute)
    assert get_compute("event") is get_compute("event")
    ev = EventCompute(mode="gather")
    assert get_compute(ev) is ev
    with pytest.raises(ValueError):
        get_compute("nope")
    with pytest.raises(ValueError):
        EventCompute(mode="pallas")

    class Tagged(DenseCompute):
        name = "tagged"
    C.register_compute("tagged", Tagged)
    try:
        assert isinstance(get_compute("tagged"), Tagged)
    finally:
        C._REGISTRY.pop("tagged", None)
        C._INSTANCES.pop("tagged", None)


# ------------------------------------------------------------ golden

def _fc_characterization():
    net = programmed_fc_network(
        [32, 48, 48, 24], weight_densities=[0.8, 0.6, 0.9],
        act_densities=[0.25, 0.5, 0.1], seed=11, **CPU)
    return net, make_inputs(32, 0.3, 8, seed=12, **CPU)


def _conv_characterization():
    rng = np.random.default_rng(13)
    layers, h, w, c_prev = [], 8, 8, 2
    for i, c in enumerate((4, 8)):
        wgt = rng.normal(0, 1 / 3.0, (3, 3, c_prev, c)).astype(np.float32)
        wgt *= _exact_density_mask(wgt.shape, 0.6, rng)
        layers.append(SimLayer(name=f"conv{i}", kind="conv",
                               weights=torch.from_numpy(wgt), stride=2,
                               in_hw=(h, w)))
        h, w, c_prev = h // 2, w // 2, c
    wfc = rng.normal(0, 0.3, (h * w * c_prev, 10)).astype(np.float32)
    layers.append(SimLayer(name="fc", kind="fc",
                           weights=torch.from_numpy(wfc)))
    net = SimNetwork(layers=layers, in_size=8 * 8 * 2)
    return net, make_inputs(net.in_size, 0.3, 6, seed=14, **CPU)


def _compiled(arch_id):
    """A compiled smoke arch and its inputs, as the reference's golden
    suite builds them."""
    def build():
        compiled = compile_network(arch_id, seed=0, **CPU)
        return compiled.net, compiled.inputs(4, seed=5)
    return build


@pytest.mark.parametrize("compute", ["dense", "gather", "kernel"])
@pytest.mark.parametrize("name,build", [
    ("fc_characterization", _fc_characterization),
    ("conv_characterization", _conv_characterization),
    ("model_lm_gemma2", _compiled("gemma2-2b")),
    ("model_ssm_mamba2", _compiled("mamba2-1.3b")),
    ("model_moe_olmoe", _compiled("olmoe-1b-7b")),
    ("model_encdec_whisper", _compiled("whisper-base"))])
def test_golden_counters_reproduced(name, build, compute):
    golden = json.loads((GOLDEN / f"{name}.json").read_text())
    net, xs = build()
    cc = {"dense": "dense", "gather": EventCompute(mode="gather"),
          "kernel": EventCompute(mode="kernel")}[compute]
    _, counters = net.run_batch(xs, compute=cc)
    assert golden["steps"] == xs.shape[0]
    for row, lay, c in zip(golden["layers"], net.layers, counters):
        assert row["name"] == lay.name
        for f in FIELDS:
            assert row[f] == int(getattr(c, f).to(torch.float64).sum()), \
                (lay.name, f)
