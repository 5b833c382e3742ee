"""The port's tensor-parallel training over gloo ranks on the CPU
(``tests/_torch_dist.py``), held to the JAX package's runs on the same
(2, 2) and (1, 4) ("data", "model") meshes of placeholder CPU devices.

* The loss and every gradient leaf of the ten smoke configs on both
  meshes (weights of the port's ``init_params(cfg, 0)``, a (4, 16) batch
  from ``default_rng(3)``; data rows split over the data axis, experts
  over it too), and of granite, olmoe and gemma2 under
  ``PerfFlags(True, True)`` (Megatron-SP and the sliced MoE dispatch).
  On (2, 2) the MoE archs drop tokens per data shard, so they are held
  to the reference's (2, 2) run, which differs from one device's.
* ``shard_params`` then ``params_to_numpy`` gives back each tree bit for
  bit.
* granite's ``Trainer`` with AdamW, 6 steps on each mesh from one step-0
  checkpoint; the (2, 2) run's step-3 checkpoint resumed on (1, 4)
  (elastic); Adafactor (``min_dim_factored=16``, so that the smoke
  leaves are factored: rows and columns split over the model group) on
  granite (1, 4) and on kimi-k2's experts split over both axes (2, 2).

Tolerances, and why: the loss within ``LOSS_ATOL``, the other metrics
within ``METRIC_RTOL`` (the z-loss, near 44, has an ulp of 3.8e-6), every
gradient leaf within ``GRAD_REL`` of its largest entry (float32 sums split over ranks
against XLA's order; the acceptance bounds); trainer losses within
``CURVE_RTOL`` of the reference's (the float32 differences above through
AdamW's and Adafactor's steps).
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest

from _torch_dist import (GRANITE, _optimizer, start_ranks,
                         start_reference, write_inputs)
from repro_torch.configs import registry

LOSS_ATOL = 2e-6
METRIC_RTOL = 1e-6
GRAD_REL = 1e-5
CURVE_RTOL = 1e-5
MESHES = [(2, 2), (1, 4)]
ARCHS = registry.ARCH_IDS
FLAG_ARCHS = ["granite-3-2b", "olmoe-1b-7b", "gemma2-2b"]
KIMI = dict(arch="kimi-k2-1t-a32b", seq=16, batch=8, seed=5, lr=2e-3)
STEPS, ADA_STEPS, MIN_DIM = 6, 4, 16


def _step0(d, spec: dict, t: dict) -> str:
    """A step-0 checkpoint of ``spec``'s arch (the port's weights of seed
    0, the optimizer's first state) in the layout both packages read."""
    import types

    from repro_torch.models import lm
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import optim, schedules
    from repro_torch.train import step as S
    model = lm.init_params(registry.get(spec["arch"]).smoke(), 0, "cpu")
    opt = _optimizer(types.SimpleNamespace(optim=optim,
                                           schedules=schedules), t)
    ckpt_lib.save(str(d), 0, S.init_state(model, opt),
                  extra={"data_step": 0})
    return str(d)


def _trainer(base, name: str, spec: dict, opt: str, steps: int, **kw):
    t = {"name": name, "spec": spec, "opt": opt, "steps": steps,
         "min_dim": MIN_DIM, **kw}
    t["ckpt"] = _step0(base / f"step0_{name}", spec, t)
    return t


def _port_copy(t: dict, d) -> dict:
    """``t`` resumed by the port from its own copy of the checkpoint."""
    shutil.copytree(t["ckpt"], d)
    return {**t, "ckpt": str(d)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh: (reference result, rank results)} and the elastic run."""
    base = tmp_path_factory.mktemp("tp_train")
    inputs = write_inputs(ARCHS, base / "inputs")
    cases = [[a, False] for a in ARCHS] + [[a, True] for a in FLAG_ARCHS]
    trainers = {
        (2, 2): [_trainer(base, "adamw22", GRANITE, "adamw", STEPS),
                 _trainer(base, "ada_kimi", KIMI, "adafactor", ADA_STEPS)],
        (1, 4): [_trainer(base, "adamw14", GRANITE, "adamw", STEPS),
                 _trainer(base, "ada_granite", GRANITE, "adafactor",
                          ADA_STEPS)]}
    refs = {m: start_reference("tp_train", 4, {
        "shape": m, "inputs": inputs, "cases": cases,
        "trainers": trainers[m]}, base=base) for m in MESHES}
    port = {}
    # (2, 2) first: its step-3 checkpoint resumes on (1, 4)
    t22 = [_port_copy(trainers[(2, 2)][0], base / "port_adamw22"),
           _port_copy(trainers[(2, 2)][1], base / "port_ada_kimi")]
    t22[0]["ckpt_every"] = 3
    port[(2, 2)] = start_ranks("tp_train", 4, {
        "shape": (2, 2), "inputs": inputs, "cases": cases,
        "trainers": t22}, base=base).wait()
    elastic = base / "port_elastic"
    shutil.copytree(t22[0]["ckpt"], elastic)
    (elastic / f"step_{STEPS:08d}.npz").unlink()
    t14 = [_port_copy(trainers[(1, 4)][0], base / "port_adamw14"),
           _port_copy(trainers[(1, 4)][1], base / "port_ada_granite"),
           {**t22[0], "name": "elastic", "ckpt": str(elastic)}]
    port[(1, 4)] = start_ranks("tp_train", 4, {
        "shape": (1, 4), "inputs": inputs, "cases": cases,
        "trainers": t14}, base=base).wait()
    return {m: (refs[m].wait(), port[m]) for m in MESHES}


def _case(runs, mesh, arch, flags):
    ref, port = runs[mesh]
    key = f"{arch}|{int(flags)}"
    got = {k[len(key) + 1:]: v for k, v in port[0]["arrays"].items()
           if k.startswith(key + "|")}
    want = {k[len(key) + 1:]: v for k, v in ref["arrays"].items()
            if k.startswith(key + "|")}
    return (port[0]["metrics"][key], got), (ref["metrics"][key], want)


def _held(runs, mesh, arch, flags) -> None:
    (gm, got), (wm, want) = _case(runs, mesh, arch, flags)
    assert sorted(gm) == sorted(wm)
    assert abs(gm["loss"] - wm["loss"]) <= LOSS_ATOL
    for k in wm:        # z_loss ~ 44: 2e-6 is below its ulp
        np.testing.assert_allclose(gm[k], wm[k], rtol=METRIC_RTOL,
                                   atol=LOSS_ATOL, err_msg=k)
    assert got and sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=GRAD_REL * np.abs(w).max(),
                                   err_msg=f"{arch} {k}")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
def test_loss_and_grads_match_reference(runs, mesh, arch):
    _held(runs, mesh, arch, False)


@pytest.mark.parametrize("arch", FLAG_ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
def test_perf_flags_match_reference(runs, mesh, arch):
    """``PerfFlags(moe_sp_dispatch=True, sp_residual=True)``: the
    residual sequence-sharded between blocks, the MoE payload sliced."""
    _held(runs, mesh, arch, True)


@pytest.mark.parametrize("mesh", MESHES, ids=["2x2", "1x4"])
def test_every_rank_reports_the_same_metrics(runs, mesh):
    _, port = runs[mesh]
    for res in port[1:]:
        assert res["metrics"] == port[0]["metrics"]


def test_moe_drops_per_data_shard(runs):
    """kimi-k2's capacity is counted per data shard: (2, 2) drops other
    tokens than (1, 4), in both packages alike."""
    loss = {m: _case(runs, m, "kimi-k2-1t-a32b", False)[0][0]["loss"]
            for m in MESHES}
    assert abs(loss[(2, 2)] - loss[(1, 4)]) > 1e-4


@pytest.mark.parametrize("arch", ARCHS)
def test_shard_params_round_trip(runs, arch):
    """``shard_params`` then ``params_to_numpy`` on every rank of both
    meshes: the tree written, bit for bit (fused halves in order)."""
    for mesh in MESHES:
        assert all(res["round_trip"][arch] for res in runs[mesh][1])


def _losses(runs, mesh, name):
    ref, port = runs[mesh]
    return ([h for h in port[0]["trainers"][name]["losses"]],
            ref["trainers"][name])


@pytest.mark.parametrize("mesh,name", [((2, 2), "adamw22"),
                                       ((1, 4), "adamw14")],
                         ids=["2x2", "1x4"])
def test_adamw_trainer_matches_reference(runs, mesh, name):
    got, want = _losses(runs, mesh, name)
    assert len(got) == len(want) == STEPS
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL)
    for res in runs[mesh][1][1:]:
        assert res["trainers"][name] == runs[mesh][1][0]["trainers"][name]


def test_elastic_resume_continues_the_curve(runs):
    """The (2, 2) run's step-3 checkpoint (every leaf gathered whole)
    resumed on (1, 4) continues the reference's (2, 2) curve."""
    _, port = runs[(1, 4)]
    res = port[0]["trainers"]["elastic"]
    want = runs[(2, 2)][0]["trainers"]["adamw22"]
    assert res["start"] == 3 and len(res["losses"]) == STEPS - 3
    np.testing.assert_allclose(res["losses"], want[3:], rtol=CURVE_RTOL)


@pytest.mark.parametrize("mesh,name", [((1, 4), "ada_granite"),
                                       ((2, 2), "ada_kimi")],
                         ids=["granite-1x4", "kimi-2x2"])
def test_adafactor_matches_reference(runs, mesh, name):
    got, want = _losses(runs, mesh, name)
    assert len(got) == len(want) == ADA_STEPS
    np.testing.assert_allclose(got, want, rtol=CURVE_RTOL)
