"""The port's model-zoo frontend against the JAX package's, on the CPU.

Both packages draw weights and gates from ``np.random.default_rng(seed)``
in the same order, so every registry arch compiles to bit-identical
weights, masks and gates; the lowering tables (pure arithmetic) agree
field by field at smoke and at full width.  The closed forms the JAX
package's own suite checks (widths chain, parameter identity, MACs =
T * macs_per_token, MoE top-k density, the attention window) hold in the
port, compiled networks price to the reference's reports at rtol 1e-9,
and ``attention_probe`` holds the flash wrapper to its plain version, and
at the JAX probe's own draws to the Pallas kernel.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _repro_reference import reference
from repro_torch.configs import registry
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.neuromorphic import (attention_probe, compile_network,
                                      excluded_params, loihi2_like,
                                      lowering_spec, simulate)
from test_torch_pricing import assert_reports_match

ARCHS = registry.ARCH_IDS
CPU = dict(device="cpu")
SCALAR_FIELDS = ("name", "kind", "neuron_model", "force_active", "decay",
                 "threshold", "sends_deltas")
#: The context the full configs are lowered at in ``chip_smoke.py``.
FULL_SEQ = {"whisper-base": 448, "gemma2-2b": 8192}


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def assert_nets_identical(rn, pn):
    assert rn.in_size == pn.in_size
    assert len(rn.layers) == len(pn.layers)
    for a, b in zip(rn.layers, pn.layers):
        for f in SCALAR_FIELDS:
            assert getattr(a, f) == getattr(b, f), (a.name, f)
        assert np.array_equal(a.weights, b.weights.numpy()), a.name
        assert b.weights.dtype == torch.float32
        if a.msg_gate is None:
            assert b.msg_gate is None, a.name
        else:
            assert np.array_equal(a.msg_gate, b.msg_gate.numpy()), a.name


# ------------------------------------------------- against the reference

def test_registry_matches_reference(ref):
    assert registry.ARCH_IDS == ref.registry.ARCH_IDS
    for arch in ARCHS:
        a, b = ref.registry.get(arch), registry.get(arch)
        assert a.family == b.family
        for ca, cb in ((a.config, b.config), (a.smoke(), b.smoke())):
            assert dataclasses.asdict(ca) == dataclasses.asdict(cb), arch
            assert ca.param_count() == cb.param_count()
            if hasattr(ca, "active_param_count"):
                assert ca.active_param_count() == cb.active_param_count()
            else:
                assert dataclasses.asdict(ca.mc) == dataclasses.asdict(cb.mc)
            assert ref.frontend.excluded_params(ca) == excluded_params(cb)


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lowering_tables_match_reference(ref, arch, smoke):
    """Field by field, at the smoke config and at the full config's own
    context (pure arithmetic: no weights are built)."""
    seq = FULL_SEQ.get(arch, 4096) if not smoke else 16
    ra, pa = ref.registry.get(arch), registry.get(arch)
    rcfg = ra.smoke() if smoke else ra.config
    pcfg = pa.smoke() if smoke else pa.config
    for neuron in ("ssm", "sd_relu"):
        rs, ratt = ref.frontend.lowering_spec(rcfg, seq_len=seq,
                                              recurrent_neuron=neuron)
        ps, patt = lowering_spec(pcfg, seq_len=seq, recurrent_neuron=neuron)
        assert [dataclasses.asdict(s) for s in rs] == \
            [dataclasses.asdict(s) for s in ps]
        assert [dataclasses.asdict(s) for s in ratt] == \
            [dataclasses.asdict(s) for s in patt]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("arch", ARCHS)
def test_compiled_weights_bit_identical(ref, arch, seed):
    rc = ref.frontend.compile_network(arch, seed=seed)
    pc = compile_network(arch, seed=seed, **CPU)
    assert_nets_identical(rc.net, pc.net)
    assert (rc.name, rc.arch_id, rc.family, rc.seq_len) == \
        (pc.name, pc.arch_id, pc.family, pc.seq_len)
    assert rc.macs_per_token() == pc.macs_per_token()
    assert np.array_equal(np.asarray(rc.inputs(3, seed=seed)),
                          pc.inputs(3, seed=seed).numpy())


@pytest.mark.parametrize("act_density,neuron", [
    (0.25, "ssm"), ([0.2, 0.9, 0.5], "ssm"), (None, "sd_relu")])
def test_densities_and_recurrent_lowering_bit_identical(ref, act_density,
                                                        neuron):
    """Programmed densities draw their gates from the same rng stream
    after each layer's weights; the sigma-delta lowering changes neuron
    fields only."""
    for arch in ("olmoe-1b-7b", "mamba2-1.3b"):
        rc = ref.frontend.compile_network(arch, act_density=act_density,
                                          recurrent_neuron=neuron, seed=3)
        pc = compile_network(arch, act_density=act_density,
                             recurrent_neuron=neuron, seed=3, **CPU)
        assert_nets_identical(rc.net, pc.net)


@pytest.mark.parametrize("arch,neuron", [("gemma2-2b", "ssm"),
                                         ("whisper-base", "ssm"),
                                         ("mamba2-1.3b", "sd_relu")])
def test_compiled_reports_match_reference(ref, arch, neuron):
    rc = ref.frontend.compile_network(arch, recurrent_neuron=neuron, seed=0)
    pc = compile_network(arch, recurrent_neuron=neuron, seed=0, **CPU)
    xs = np.asarray(rc.inputs(4, seed=5))
    r = ref.timestep.simulate(rc.net, xs, ref.platform.loihi2_like())
    p = simulate(pc.net, torch.from_numpy(xs), loihi2_like())
    assert_reports_match(r, p)


# ------------------------------------------------ closed forms, in the port

@pytest.mark.parametrize("arch", ARCHS)
def test_widths_chain_and_nnz(arch):
    cn = compile_network(arch, **CPU)
    prev = cn.cfg.d_model
    assert cn.net.in_size == cn.d_model == cn.cfg.d_model
    for spec, layer in zip(cn.specs, cn.net.layers):
        assert layer.kind == "fc"
        assert spec.fanin == prev == layer.weights.shape[0]
        assert spec.width == layer.weights.shape[1]
        assert layer.w_nnz == spec.nnz, spec.name
        prev = spec.width
    assert prev == cn.cfg.vocab_size


@pytest.mark.parametrize("arch", ARCHS)
def test_param_identity_and_mac_closed_form(arch):
    cn = compile_network(arch, seed=1, **CPU)
    assert cn.param_layer_nnz() + excluded_params(cn.cfg) == \
        cn.cfg.param_count()
    T = 3
    _, counters = cn.net.run_batch(cn.inputs(T, seed=2))
    for spec, c in zip(cn.specs, counters):
        assert int(c.macs.sum()) == T * spec.macs_per_token, spec.name


def test_attention_context_window():
    cfg = registry.get("gemma2-2b").smoke()
    specs, attn = lowering_spec(cfg, seq_len=12)
    widths = {s.name: s.width for s in specs}
    assert widths["b0.attn.scores"] == cfg.n_heads * 8     # window=8
    assert widths["b1.attn.scores"] == cfg.n_heads * 12    # global
    assert attn[0].window == 8 and attn[1].window is None


def test_moe_router_topk_drives_density():
    cfg = registry.get("olmoe-1b-7b").smoke()
    moe = cfg.pattern[0].moe
    cn = compile_network(cfg, seed=4, **CPU)
    up = next(l for l in cn.net.layers if l.name.endswith("experts_up"))
    f = moe.d_ff
    active = (moe.top_k + moe.n_shared_experts) * 2 * f + moe.n_experts
    assert int(up.msg_gate.sum()) == active
    _, counters = cn.net.run_batch(cn.inputs(2, seed=5))
    i_dn = next(i for i, l in enumerate(cn.net.layers)
                if l.name.endswith("experts_down"))
    per_tok = (moe.top_k + moe.n_shared_experts) * f * cfg.d_model
    assert int(counters[i_dn].macs.sum()) == 2 * per_tok
    assert int(counters[i_dn].macs.sum()) < 2 * cn.net.layers[i_dn].w_nnz


def test_full_whisper_lowering_at_its_decoder_context():
    """The full-width workload of ``chip_smoke.py``: 97 fc layers, 0.435 G
    weight entries, 18 attention sites of three kinds (arithmetic only)."""
    cfg = registry.get("whisper-base").config
    specs, attn = lowering_spec(cfg, seq_len=448)
    assert len(specs) == 97
    assert sum(s.fanin * s.width for s in specs) == 434_896_896
    assert sum(s.nnz for s in specs) == 104_546_304
    kinds = {(a.seq, a.causal, a.cross) for a in attn}
    assert len(attn) == 18
    assert kinds == {(1500, False, False), (448, True, False),
                     (1500, False, True)}
    assert sum(s.param_nnz for s in specs) + excluded_params(cfg) == \
        cfg.param_count()


# ------------------------------------------------------- attention probes

def _jax_probe_inputs(spec, seed):
    """The q, k and v the JAX package's ``attention_probe`` draws."""
    import jax
    kq, kk, kv = jax.random.split(jax.random.PRNGKey(seed), 3)
    draw = lambda key, heads: torch.from_numpy(np.asarray(jax.random.normal(
        key, (1, spec.seq, heads, spec.head_dim), np.float32)))
    return draw(kq, spec.heads), draw(kk, spec.kv_heads), \
        draw(kv, spec.kv_heads)


def test_attention_probe_and_verified_compile(ref):
    """At every smoke attention site: the port's probe has the JAX
    package's shape, and the port's wrapper on the JAX probe's own draws
    gives the Pallas kernel's output (interpret mode) within 2e-5."""
    cn = compile_network("gemma2-2b", verify_attention=True, **CPU)
    assert len(cn.attn_specs) == 4
    for arch in ("gemma2-2b", "whisper-base", "recurrentgemma-2b",
                 "kimi-k2-1t-a32b"):
        for spec in compile_network(arch, **CPU).attn_specs:
            out, plain = attention_probe(spec, seed=3, **CPU)
            assert out.shape == (1, spec.seq, spec.heads, spec.head_dim)
            np.testing.assert_allclose(out.numpy(), plain.numpy(),
                                       rtol=2e-5, atol=2e-5)
            pallas, _ = ref.frontend.attention_probe(spec, seed=3)
            assert pallas.shape == tuple(out.shape)
            q, k, v = _jax_probe_inputs(spec, 3)
            mine = flash_attention(q, k, v, causal=spec.causal,
                                   window=spec.window, softcap=spec.softcap)
            np.testing.assert_allclose(mine.numpy(), pallas,
                                       rtol=2e-5, atol=2e-5)
    a, _ = attention_probe(cn.attn_specs[0], seed=3, **CPU)
    b, _ = attention_probe(cn.attn_specs[0], seed=3, **CPU)
    assert torch.equal(a, b)


def test_attention_probe_is_the_reference_probe(ref):
    """The probe draws the JAX package's q, k and v (``prng.normal`` from
    ``split(PRNGKey(seed), 3)``), so its outputs are the reference
    probe's: the wrapper's within flash's 2e-4 of the Pallas kernel's
    (interpret mode), the plain version's of the oracle's."""
    for arch in ("gemma2-2b", "whisper-base", "kimi-k2-1t-a32b"):
        for spec in compile_network(arch, **CPU).attn_specs:
            out, plain = attention_probe(spec, seed=5, **CPU)
            pallas, oracle = ref.frontend.attention_probe(spec, seed=5)
            np.testing.assert_allclose(out.numpy(), pallas, rtol=2e-4,
                                       atol=2e-4)
            np.testing.assert_allclose(plain.numpy(), oracle, rtol=2e-4,
                                       atol=2e-4)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    spec = compile_network("gemma2-2b", **CPU).attn_specs[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        compile_network("gemma2-2b")
    with pytest.raises(RuntimeError, match="cuda"):
        attention_probe(spec)
