"""The yardstick's counts against hand-worked ones, and the frozen
lowering against the port's frontend."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from bench import counting, harness, lowering
from bench.conftest import ROOT, SMOKE_CONFIGS


def test_product_need_sparse_ragged_float32():
    # M=130, K=200, N=300: tiles rm=(128, 2), rk=(128, 72), rn=(128, 128, 44)
    act = np.array([[1, 0], [1, 1]], bool)
    occ = np.array([[1, 0, 1], [0, 1, 1]], bool)
    need = counting.product_need(act, occ, 130, 200, 300, "float32")
    # needed (m, k, n): m0 k0 n{0,2}; m1 k0 n{0,2}; m1 k1 n{1,2}
    ops = 2 * (128 * 128 * (128 + 44) + 2 * 128 * (128 + 44)
               + 2 * 72 * (128 + 44))
    x_bytes = (128 * 128 + 2 * 128 + 2 * 72) * 4
    w_bytes = (128 * 128 + 128 * 44 + 72 * 128 + 72 * 44) * 4
    out_bytes = 130 * 300 * 4
    assert need.ops == ops == 5_773_696
    assert need.bytes == x_bytes + w_bytes + out_bytes == 360_736
    assert need.seconds == pytest.approx(360_736 / 3.35e12, rel=1e-12)


def test_product_need_published_whisper_head():
    # the head at the published vocabulary: (448, 512) @ (512, 51865),
    # every tile live; the last column tile is 25 wide (51865 = 405 * 128
    # + 25), so the ragged edge adds no operations or bytes
    act = np.ones((4, 4), bool)
    occ = np.ones((4, 406), bool)
    need = counting.product_need(act, occ, 448, 512, 51865, "float32")
    assert need.ops == 2 * 448 * 512 * 51865 == 23_793_172_480
    assert need.bytes == (448 * 512 + 512 * 51865 + 448 * 51865) * 4 \
        == 200_079_104


def test_product_need_dense_int8():
    act = np.ones((2, 2), bool)
    occ = np.ones((2, 2), bool)
    need = counting.product_need(act, occ, 256, 256, 256, "int8")
    assert need.ops == 2 * 256 ** 3
    assert need.bytes == 2 * 256 * 256 * 1 + 256 * 256 * 4
    assert need.seconds == pytest.approx(
        max(2 * 256 ** 3 / 1979e12, 393_216 / 3.35e12), rel=1e-12)


def test_mfu_hand_counts():
    assert counting.job_flops(3) == 6.0
    assert counting.mfu_percent(2e12, 1.0) == pytest.approx(100 * 2 / 495)
    # whisper-base at 448 tokens: 104,362,496 MACs a token
    flops = counting.job_flops(104_362_496 * 448)
    assert flops == 93_508_796_416
    assert counting.mfu_percent(flops, 0.2) == pytest.approx(
        100 * 93_508_796_416 / 0.2 / 495e12)


def test_occupancy_of_attention_scores():
    # 2 heads of 64 lanes, 3 positions: the q lanes (rows 0..127) feed
    # the scores; the k and v lanes (rows 128..383) feed nothing
    spec = lowering.LayerSpec("s", 384, 6, ("attn_scores", 2, 3, 64), "kv",
                              nnz=2 * 3 * 64, param_nnz=0,
                              macs_per_token=2 * 3 * 64)
    assert harness.occupancy(spec).tolist() == [[True], [False], [False]]


def test_tile_activity_and_counts_from_inputs():
    x = torch.zeros(130, 200)
    x[0, 0] = 1.0
    x[129, 150] = 2.0
    assert harness._tile_activity(x).tolist() == [[True, False],
                                                 [False, True]]


@pytest.mark.parametrize("name,seq_len,layers,entries,macs", [
    ("whisper-base", 448, 97, 434_713_088, 104_362_496),
    ("mamba2-1.3b-6of48", 1024, 19, 467_085_312, 264_235_008),
])
def test_full_lowering_hand_counts(name, seq_len, layers, entries, macs):
    cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                     .read_text())
    specs = lowering.lowering_spec(cfg, seq_len=seq_len)
    assert len(specs) == layers
    assert sum(s.fanin * s.width for s in specs) == entries
    assert sum(s.macs_per_token for s in specs) == macs
    if name == "whisper-base":
        d, f, v, q = 512, 2048, 51865, 512
        attn = lambda s: d * 3 * q + 2 * 8 * s * 64 + q * d
        mlp = d * 2 * f + f * d
        assert macs == (6 * (attn(1500) + mlp)
                        + 6 * (attn(448) + attn(1500) + mlp) + d * v)
    else:
        d, di, st, h = 2048, 4096, 128, 64
        fan = 2 * di + 2 * st + h
        assert macs == 6 * (d * fan + di * (2 * st + 2) + di * d) + d * 50277


@pytest.mark.parametrize("name", sorted(SMOKE_CONFIGS))
@pytest.mark.parametrize("neuron", ["ssm", "sd_relu"])
def test_frozen_lowering_draws_the_ports_network(name, neuron):
    from repro_torch.neuromorphic.frontend import compile_network
    cfg = SMOKE_CONFIGS[name]
    net = compile_network(harness.port_config(cfg), seq_len=16, seed=7,
                          recurrent_neuron=neuron, device="cpu").net
    specs = lowering.lowering_spec(cfg, seq_len=16, recurrent_neuron=neuron)
    drawn = list(lowering.draw_network(specs, 7))
    assert len(drawn) == len(net.layers)
    for layer, d in zip(net.layers, drawn):
        assert layer.name == d.spec.name
        assert torch.equal(layer.weights, torch.from_numpy(d.weights))
        assert (layer.neuron_model, layer.force_active, layer.decay,
                layer.threshold, layer.sends_deltas) == (
            d.spec.neuron_model, d.force_active, d.decay, d.threshold,
            d.sends_deltas)
        assert layer.msg_gate is None and d.gate is None


def test_port_config_matches_the_registry():
    """Every field as the port's registry has it, but the vocabulary: the
    files keep the published size, which the registry pads."""
    from repro_torch.configs import registry
    for name, arch, repeats, vocab in (
            ("whisper-base", "whisper-base", None, 51865),
            ("mamba2-1.3b-6of48", "mamba2-1.3b", 6, 50277)):
        cfg = json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                         .read_text())
        assert cfg["vocab_size"] == cfg["published"]["vocab_size"] == vocab
        reg = registry.get(arch).config
        assert reg.vocab_size > vocab
        reg = dataclasses.replace(reg, vocab_size=vocab)
        if repeats is not None:
            reg = dataclasses.replace(reg, n_repeats=repeats)
        assert dataclasses.replace(harness.port_config(cfg),
                                   name=reg.name) == reg


def test_reference_sums_a_senders_deltas():
    """A layer after one that sends deltas takes the running sum of the
    wire's messages; its counters count the wire's messages."""
    from bench import reference

    def layer(name, sends_deltas):
        spec = lowering.LayerSpec(name, 3, 3, ("dense",), "param", nnz=9,
                                  param_nnz=9, macs_per_token=9)
        return lowering.DrawnLayer(spec, np.eye(3, dtype=np.float32), None,
                                   force_active=False, decay=0.5,
                                   threshold=0.0, sends_deltas=sends_deltas)
    x = torch.tensor([[1.0, -2.0, 0.0], [0.5, 3.0, 0.0]])
    seen = {}
    outs = reference.run(
        [layer("a", True), layer("b", False)], {0: x}, torch.device("cpu"),
        on_layer=lambda i, l, j, c: seen.setdefault(i, c["float64"]))
    relu = x.clamp_min(0.0).to(torch.float64)
    assert torch.equal(outs["float64"][0], relu.cumsum(dim=0))
    assert seen[1]["msgs_in"].tolist() == [1.0, 2.0]
