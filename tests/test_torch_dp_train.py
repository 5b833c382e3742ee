"""The port's data-parallel ``Trainer`` over gloo ranks on the CPU
(``tests/_torch_dist.py``), held to the JAX package's ``Trainer`` on a
(4, 1) mesh of placeholder CPU devices.

Both start from the reference's step-0 checkpoint: granite-3-2b's smoke
config, a global batch of 8 x 32 tokens (``SyntheticLM``, seed 5), AdamW
at a constant 2e-3, 3 steps, exact and with ``compress_grads``.

Tolerances, and why: losses within ``LOSS_RTOL`` of the reference's
(float32 sums in another order through the forward, backward and the
cross-rank gradient sum, carried through 3 AdamW steps); an elastic or
recovered run within ``RESUME_RTOL`` of the uninterrupted run (the
reference's resume bound); ranks of one run exactly equal.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest

from _torch_dist import GRANITE, run_ranks, run_reference

LOSS_RTOL = 1e-5
RESUME_RTOL = 1e-5
STEPS = 3


@pytest.fixture(scope="module")
def ref_runs(tmp_path_factory):
    return run_reference("trainers", 4, {"spec": GRANITE, "steps": STEPS,
                                         "modes": [False, True]},
                         base=tmp_path_factory.mktemp("ref"))


def _from(ref_runs, mode: str, d) -> str:
    shutil.copytree(ref_runs[mode]["step0"], d)
    return str(d)


@pytest.fixture(scope="module")
def port_runs(ref_runs, tmp_path_factory):
    base = tmp_path_factory.mktemp("port")
    return {mode: run_ranks("trainer", 4, {
        "spec": GRANITE, "steps": STEPS, "compress": mode == "1",
        "ckpt": _from(ref_runs, mode, base / f"ck{mode}")}, base=base)
        for mode in ("0", "1")}


def _losses(res) -> list[float]:
    return [h["loss"] for h in res["history"]]


def _metrics(hist) -> list[dict]:
    """A history without its host times."""
    return [{k: v for k, v in h.items() if k not in ("dt", "straggler")}
            for h in hist]


@pytest.mark.parametrize("mode", ["0", "1"], ids=["exact", "compressed"])
def test_dp_trainer_matches_reference_on_four_ranks(ref_runs, port_runs,
                                                    mode):
    want = ref_runs[mode]["losses"]
    ranks = port_runs[mode]
    assert [h["step"] for h in ranks[0]["history"]] == [1, 2, 3]
    assert ranks[0]["start"] == 0
    np.testing.assert_allclose(_losses(ranks[0]), want, rtol=LOSS_RTOL)
    for res in ranks[1:]:
        assert _losses(res) == _losses(ranks[0])


def test_exact_and_compressed_paths_normalise_differently(port_runs):
    """Both start on the same loss; the compressed step's gradients are
    each rank's local mean, quantized, so its later losses differ."""
    exact, comp = _losses(port_runs["0"][0]), _losses(port_runs["1"][0])
    assert exact[0] == comp[0]
    assert exact[1:] != comp[1:]
    np.testing.assert_allclose(comp, exact, rtol=1e-3)


@pytest.fixture(scope="module")
def elastic(ref_runs, tmp_path_factory):
    """4 ranks for 6 steps; 2 ranks to step 3, resumed by 4 to step 6; 2
    ranks for 6 steps with a scripted fault at step 5 after a checkpoint
    at step 4."""
    base = tmp_path_factory.mktemp("elastic")
    out = {"four": run_ranks("trainer", 4, {
        "spec": GRANITE, "steps": 6,
        "ckpt": _from(ref_runs, "0", base / "four")}, base=base)}
    ck = _from(ref_runs, "0", base / "grow")
    out["two_to_3"] = run_ranks("trainer", 2, {
        "spec": GRANITE, "steps": 3, "ckpt_every": 3, "ckpt": ck},
        base=base)
    out["four_from_3"] = run_ranks("trainer", 4, {
        "spec": GRANITE, "steps": 6, "ckpt": ck}, base=base)
    out["fault"] = run_ranks("trainer", 2, {
        "spec": GRANITE, "steps": 6, "ckpt_every": 2, "fault_at": 5,
        "ckpt": _from(ref_runs, "0", base / "fault")}, base=base)
    return out


def test_elastic_resume_at_another_world_size(elastic):
    full = {h["step"]: h["loss"] for h in elastic["four"][0]["history"]}
    first = elastic["two_to_3"][0]["history"]
    assert [h["step"] for h in first] == [1, 2, 3]
    resumed = elastic["four_from_3"]
    assert all(r["start"] == 3 for r in resumed)
    hist = resumed[0]["history"]
    assert [h["step"] for h in hist] == [4, 5, 6]
    np.testing.assert_allclose([h["loss"] for h in first],
                               [full[s] for s in (1, 2, 3)],
                               rtol=RESUME_RTOL)
    np.testing.assert_allclose([h["loss"] for h in hist],
                               [full[s] for s in (4, 5, 6)],
                               rtol=RESUME_RTOL)


def test_a_fault_restores_every_rank_together(elastic):
    """The hook raises on both ranks at step 5: both restore step 4 once,
    and the run ends on the uninterrupted run's loss."""
    full = {h["step"]: h["loss"] for h in elastic["four"][0]["history"]}
    for res in elastic["fault"]:
        assert [s for s, _ in res["recoveries"]] == [5]
        last = res["history"][-1]
        assert last["step"] == 6
        np.testing.assert_allclose(last["loss"], full[6], rtol=RESUME_RTOL)
    assert _metrics(elastic["fault"][0]["history"]) \
        == _metrics(elastic["fault"][1]["history"])
