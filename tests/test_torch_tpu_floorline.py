"""The port's three-term bound (``repro_torch.core.tpu_floorline``), its op
counter (``repro_torch.core.hlo_cost``) and the backtracking hillclimb
(``repro_torch.distributed.autoshard``) against the JAX package's, on the
CPU.

``RooflineTerms``, ``parse_collectives``, ``model_flops_for`` and
``hillclimb`` are held to the reference exactly on the reference's own
scenarios (``tests/test_tpu_floorline.py``), with the reference's TPU
constants passed in.  The counter, which counts dispatched aten ops where
the reference parses HLO text, is held to hand counts of small functions;
``tests/test_torch_dryrun.py`` holds it to the reference's HLO counts of
the smoke configs' train steps.
"""

import pytest
import torch

from _repro_reference import reference
from repro_torch.configs import registry
from repro_torch.core import hlo_cost
from repro_torch.core import tpu_floorline as tfl
from repro_torch.core.analytical import Bottleneck
from repro_torch.distributed import autoshard

V5E = dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9)


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


# the reference's RooflineTerms scenarios (tests/test_tpu_floorline.py)
TERMS = [(197e12, 819e9, 0, 1.0, 1), (1e12, 819e9 * 5, 0, 1.0, 1),
         (1e12, 1e9, 50e9 * 100, 1.0, 1), (3e14, 2e12, 4e10, 5e14, 4)]


@pytest.mark.parametrize("flops,hbm,coll,mf,chips", TERMS)
def test_roofline_terms_match_reference(ref, flops, hbm, coll, mf, chips):
    want = ref.tpu_floorline.RooflineTerms(flops, hbm, coll, model_flops=mf,
                                 n_chips=chips, label="x")
    got = tfl.RooflineTerms(flops, hbm, coll, model_flops=mf, n_chips=chips,
                            label="x", **V5E)
    assert got.row() == want.row()
    assert got.dominant.value == want.dominant.value
    assert got.recommendation() == want.recommendation()
    assert (got.t_compute, got.t_memory, got.t_collective, got.bound) == (
        want.t_compute, want.t_memory, want.t_collective, want.bound)


def test_terms_default_to_the_h100():
    """989 TFLOP/s bf16, 3.35 TB/s, NVLink 4's 450 GB/s; the collective
    term of one card is 0 and stays a term."""
    t = tfl.RooflineTerms(flops_per_chip=989e12, hbm_bytes_per_chip=3.35e12,
                          collective_bytes_per_chip=0, model_flops=989e12)
    assert abs(t.t_compute - 1.0) < 1e-12 and abs(t.t_memory - 1.0) < 1e-12
    assert t.t_collective == 0.0 and "t_collective_s" in t.row()
    assert t.useful_flops_ratio == 1.0
    t2 = tfl.RooflineTerms(1e12, 3.35e12 * 5, 0, model_flops=1.0)
    assert t2.dominant == Bottleneck.MEMORY
    t3 = tfl.RooflineTerms(1e12, 1e9, 450e9 * 100, model_flops=1.0)
    assert t3.dominant == Bottleneck.TRAFFIC
    assert "collective" in t3.recommendation()
    count = hlo_cost.HloCost(flops=2e12, hbm_bytes=1e9,
                             flops_by_dtype={"bfloat16": 2e12})
    t4 = tfl.terms_from_step(count, model_flops=1e12, label="s")
    assert (t4.flops_per_chip, t4.hbm_bytes_per_chip,
            t4.collective_bytes_per_chip, t4.useful_flops_ratio) == (
        2e12, 1e9, 0.0, 0.5)
    assert t4.t_compute == 2e12 / 989e12


def test_compute_term_prices_each_dtype_at_its_peak():
    """float32 products run outside the tensor cores at 67 TFLOP/s, bf16
    on them at 989: a step's compute term is the sum of the two times."""
    count = hlo_cost.HloCost(flops=6.7e12 + 9.89e12, hbm_bytes=0.0,
                             flops_by_dtype={"float32": 6.7e12,
                                             "bfloat16": 9.89e12})
    t = tfl.terms_from_step(count, model_flops=1.0)
    assert abs(t.t_compute - (0.1 + 0.01)) < 1e-12
    assert t.dominant == Bottleneck.COMPUTE
    one_peak = tfl.RooflineTerms(count.flops, 0.0, 0.0)
    assert one_peak.t_compute == count.flops / 989e12 < t.t_compute
    with pytest.raises(ValueError, match="float64"):
        tfl.RooflineTerms(1.0, 0.0, 0.0,
                          flops_by_dtype={"float64": 1.0}).t_compute


def test_model_flops_rules_match_reference(ref):
    """MoE counts active parameters only (kimi-k2's 1 T, 32 B active)."""
    want_cfg = ref.registry.get("kimi-k2-1t-a32b").config
    cfg = registry.get("kimi-k2-1t-a32b").config
    assert cfg.active_param_count() == want_cfg.active_param_count()
    assert tfl.model_flops_for(cfg, "train", 4096, 256) \
        == 6.0 * cfg.active_param_count() * 4096 * 256
    for arch in ("kimi-k2-1t-a32b", "gemma2-2b", "whisper-base"):
        c, w = registry.get(arch).config, ref.registry.get(arch).config
        for kind, s, b in (("train", 4096, 256), ("prefill", 32768, 32),
                           ("decode", 32768, 128)):
            assert tfl.model_flops_for(c, kind, s, b) \
                == ref.tpu_floorline.model_flops_for(w, kind, s, b), (arch, kind)


def test_parse_collectives_matches_reference(ref):
    text = """
  %all-gather.5 = bf16[4,32,16,64]{3,2,1,0} all-gather(bf16[4,2,16,64]{3,2,1,0} %p), replica_groups=[16,16]<=[256], dimensions={1}
  %all-reduce.1 = f32[128]{0} all-reduce(f32[128]{0} %q), replica_groups={}
  %rs.2 = (f32[64]{0}) reduce-scatter-start(f32[512]{0} %r), replica_groups=[2,8]
  %rs.3 = f32[64]{0} reduce-scatter-done(%rs.2)
"""
    st, want = tfl.parse_collectives(text), ref.tpu_floorline.parse_collectives(text)
    assert (st.bytes_by_kind, st.count_by_kind, st.ops, st.total_bytes) == (
        want.bytes_by_kind, want.count_by_kind, want.ops, want.total_bytes)
    assert st.count_by_kind == {"all-gather": 1, "all-reduce": 1,
                                "reduce-scatter": 1}
    assert st.bytes_by_kind["all-gather"] == 4 * 2 * 16 * 64 * 2


def _scenario(Move, B):
    """The reference's accept-and-backtrack scenario, plus a move on
    another term that helps only after the first."""
    calls = []

    def evaluate(**kw):
        calls.append(dict(kw))
        bound = 10.0
        if kw.get("good"):
            bound -= 4.0
        if kw.get("bad"):
            bound += 1.0
        if kw.get("late") and kw.get("good"):
            bound -= 3.0
        return {"bound_s": bound, "t_compute_s": 1, "t_memory_s": bound,
                "t_collective_s": 0.1, "dominant": "memory"}

    moves = [
        Move("bad-move", "should regress", B.MEMORY, {"bad": True}),
        Move("late-move", "helps after good", B.COMPUTE, {"late": True}),
        Move("good-move", "should help", B.MEMORY, {"good": True}),
    ]
    return evaluate, moves, calls


def test_hillclimb_matches_reference_step_by_step(ref):
    from repro.core.analytical import Bottleneck as RB
    r_eval, r_moves, r_calls = _scenario(ref.autoshard.Move, RB)
    p_eval, p_moves, p_calls = _scenario(autoshard.Move, Bottleneck)
    want = ref.autoshard.hillclimb(r_eval, r_moves)
    got = autoshard.hillclimb(p_eval, p_moves)
    assert p_calls == r_calls
    assert got.best == want.best == {**got.best, "bound_s": 3.0}
    assert got.best_overrides == want.best_overrides
    assert [(s.iteration, s.move, s.before, s.after, s.accepted, s.verdict)
            for s in got.log] == [
        (s.iteration, s.move, s.before, s.after, s.accepted, s.verdict)
        for s in want.log]
    assert got.markdown() == want.markdown()
    assert "| good-move |" in got.markdown()


def test_card_moves():
    """One card's moves: the other remat policy and 4x / 16x fewer
    microbatches where they divide."""
    names = [m.name for m in autoshard.card_moves(256, "block")]
    assert names == ["remat-none", "microbatches-64", "microbatches-16"]
    moves = autoshard.card_moves(8, "none")
    assert [(m.name, m.overrides) for m in moves] == [
        ("remat-block", {"remat": "block"}),
        ("microbatches-2", {"microbatches": 2})]


# ------------------------------------------------------------- the counter

def test_counts_a_product_by_hand():
    """``(8, 16) @ (16, 4)`` in float32: 2 * 8 * 4 * 16 FLOPs; both operands
    read and the result written once."""
    a, b = torch.ones(8, 16), torch.ones(16, 4)
    c = hlo_cost.analyze(torch.matmul, a, b)
    assert c.flops == 2 * 8 * 4 * 16
    assert c.hbm_bytes == (8 * 16 + 16 * 4 + 8 * 4) * 4
    assert c.flops_by_dtype == {"float32": 2 * 8 * 4 * 16}
    assert c.collective_bytes == 0 and c.bytes_by_kind == {}
    assert c.top_dots == [("x1 mm((8, 16), (16, 4))", 1024.0)]
    assert c.peak_live_bytes == 8 * 4 * 4
    # batched, and the out_dtype overload the card's bf16 logits use
    x = torch.ones(3, 8, 16, dtype=torch.bfloat16)
    y = torch.ones(3, 16, 4, dtype=torch.bfloat16)
    assert hlo_cost.analyze(torch.bmm, x, y).flops == 3 * 2 * 8 * 4 * 16
    m = hlo_cost.analyze(torch.mm, x[0].to("meta"), y[0].to("meta"),
                         out_dtype=torch.float32)          # no CPU kernel
    assert m.flops == 2 * 8 * 4 * 16
    assert m.hbm_bytes == (8 * 16 + 16 * 4) * 2 + 8 * 4 * 4


def test_a_view_chain_moves_nothing():
    x = torch.ones(4, 6)
    c = hlo_cost.analyze(lambda: x.t().reshape(6, 4).detach().expand(
        2, 6, 4).transpose(1, 2)[:, 1:].unsqueeze(0).view(1, 2, 3, 6))
    assert (c.flops, c.hbm_bytes, c.n_ops, c.peak_live_bytes) == (0, 0, 0, 0)


def test_in_place_add_reads_and_writes():
    x, y = torch.ones(10), torch.ones(10)
    assert hlo_cost.analyze(lambda: x.add_(y)).hbm_bytes == 3 * 40
    assert hlo_cost.analyze(lambda: x.add_(1.0)).hbm_bytes == 2 * 40
    # out of place: two reads, one fresh write that stays live
    c = hlo_cost.analyze(torch.add, x, y)
    assert c.hbm_bytes == 3 * 40 and c.peak_live_bytes == 40


def test_broadcast_operand_is_read_once_and_scores_are_marked():
    """A score block (B, K, G, Sq, Skv) of the caller's (Sq, Skv) is marked;
    with no score dims given, or for a 3-D tensor of the same trailing
    dims, nothing is."""
    row = torch.ones(1, 4096)
    c = hlo_cost.analyze(lambda: row.expand(8, 4096) * 2.0)
    assert c.hbm_bytes == 4096 * 4 + 8 * 4096 * 4
    s = torch.empty(2, 1, 1, 2048, 1024, device="meta")
    with hlo_cost.counting({(2048, 1024)}) as c:
        torch.softmax(s, -1)
    assert c.result().score_bytes == c.result().hbm_bytes == 2 * s.numel() * 4
    assert hlo_cost.analyze(torch.softmax, s, -1).score_bytes == 0
    with hlo_cost.counting({(2048, 1024)}) as c:
        torch.softmax(s.view(2, 2048, 1024), -1)
    assert c.result().score_bytes == 0 < c.result().hbm_bytes


def test_adamw_over_a_weight_adds_no_score_bytes():
    """gemma2-2b's (2304, 9216) MLP matrix passes the reference's shape rule
    (trailing dims >= 512, >= 4 Mi elements), but neither it, its gradient
    nor its AdamW state is an attention score: counted with the scores of
    a 2 x 1024 cell, its update moves no score bytes."""
    from repro_torch.train import optim, schedules
    w = torch.empty(2304, 9216, dtype=torch.bfloat16, device="meta")
    g = torch.empty_like(w)
    opt = optim.adamw(schedules.constant(1e-4))
    state = opt.init({"w": w})
    with hlo_cost.counting({(1024, 1024)}) as c:
        opt.update({"w": g}, state, {"w": w},
                   torch.zeros((), dtype=torch.int32, device="meta"))
    got = c.result()
    assert got.hbm_bytes > 10 * w.numel() * 4 and got.score_bytes == 0


def test_trips_scale_a_window_and_live_bytes_are_released():
    a = torch.ones(32, 32)

    def loop(counter):
        with counter.trips("body", 5):
            t = a @ a
            del t
        return a @ a

    with hlo_cost.counting() as c:
        loop(c)
    got = c.result()
    one = hlo_cost.analyze(torch.mm, a, a)
    assert got.flops == 6 * one.flops and got.hbm_bytes == 6 * one.hbm_bytes
    assert got.while_trips == {"body": 5}
    assert got.peak_live_bytes == 32 * 32 * 4     # the first one died


def test_analyze_raises_when_a_ported_kernel_launches():
    """The kernels are ctypes-bound, unseen by the dispatch mode: a launch
    inside the window must not pass as a smaller count."""
    from repro_torch.kernels.sigma_delta.ops import window_cumsum
    before = window_cumsum.launches

    def launch():
        window_cumsum.launches += 1         # a stub launch counter
    try:
        with pytest.raises(RuntimeError, match="window_cumsum"):
            hlo_cost.analyze(launch)
    finally:
        window_cumsum.launches = before
    assert hlo_cost.analyze(lambda: None).flops == 0


def test_counter_sees_autograd_and_meta():
    """The backward's products are counted (the forward's and the weight
    gradient's; the input needs none), on meta tensors as on the CPU."""
    for dev in ("cpu", "meta"):
        w = torch.ones(16, 8, device=dev, requires_grad=True)
        x = torch.ones(4, 16, device=dev)
        c = hlo_cost.analyze(lambda: (x @ w).sum().backward())
        assert c.flops == 2 * (2 * 4 * 8 * 16), dev
