"""The port's expert-parallel MoE over gloo ranks on the CPU
(``tests/_torch_dist.py``), held to the JAX package's ``_local_moe`` under
``shard_map`` on a (4, 1) mesh of placeholder CPU devices.

olmoe-1b-7b's smoke config, weights from ``PRNGKey(0)`` carried across
(``params_from_numpy``; each rank keeps its block of experts,
``moe.shard_experts``), a (4, 16) batch drawn as the reference's
``tests/test_models.py`` draws its batches (seed 0), one row a rank.
Capacity is computed from each shard's own tokens, so the 4-rank run
drops tokens (``dropped_frac`` 0.2578125) where one device drops none.

Tolerances, and why: the loss and every aux value within ``RTOL`` of the
reference's (float32 sums in another order; the integer loads and the
dropped fraction exactly); a one-rank group bit for bit against no group;
the DP + EP trainer's losses within 1e-5 over 2 AdamW steps, and its
step-2 checkpoint within ``PARAM_ATOL`` of the reference's (a tenth of
the learning rate, as the port's other end-to-end steps).
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from _torch_dist import OLMOE, run_ranks, run_reference

RTOL = 1e-6
# AdamW's normalised update turns a roundoff in a near-zero gradient into a
# step of order lr: the other float32 steps' bound (tests/test_torch_optim.py)
PARAM_ATOL = 0.1 * OLMOE["lr"]
EXACT = ("dropped_frac", "max_expert_load")


@pytest.fixture(scope="module")
def ref_loss(tmp_path_factory):
    return run_reference("olmoe_loss", 4, {"seed": 0},
                         base=tmp_path_factory.mktemp("ref"))


def _args(ref_loss, **kw) -> dict:
    return {"params": ref_loss["params"], "batch": ref_loss["batch"], **kw}


def _close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if k in EXACT:
            assert got[k] == w, k
        else:
            np.testing.assert_allclose(got[k], w, rtol=RTOL, err_msg=k)


def test_ep_loss_and_aux_match_reference_on_four_ranks(ref_loss, tmp_path):
    out = run_ranks("olmoe_loss", 4, _args(ref_loss), base=tmp_path)
    want = ref_loss["mesh"]
    assert want["dropped_frac"] == 0.2578125
    for res in out:
        _close(res["metrics"], want)
        assert res["metrics"] == out[0]["metrics"]


def test_one_device_loss_matches_reference(ref_loss, tmp_path):
    out = run_ranks("olmoe_loss", 1, _args(ref_loss, ep=False),
                    base=tmp_path)[0]
    _close(out["metrics"], ref_loss["one"])
    assert out["metrics"]["dropped_frac"] == 0.0


def test_one_rank_group_is_bit_identical(ref_loss, tmp_path):
    """Experts "sharded" over one rank run the all_to_all and the
    all-reduces on a group of one: the bits of the call without one."""
    ep = run_ranks("olmoe_loss", 1, _args(ref_loss), base=tmp_path)[0]
    plain = run_ranks("olmoe_loss", 1, _args(ref_loss, ep=False),
                      base=tmp_path)[0]
    assert ep["metrics"] == plain["metrics"]


def test_sp_dispatch_is_not_ported():
    """``sp_dispatch`` slices the payload over the model group; without
    one (the reference's ``tp = 1``) it slices nothing: the bits of the
    call without it.  Over model groups it is held in
    ``tests/test_torch_tp_train.py``."""
    from repro_torch.configs import registry
    from repro_torch.models import lm, moe
    cfg = registry.get("olmoe-1b-7b").smoke()
    model = lm.init_params(cfg, 0, "cpu")
    blk = next(b for b in cfg.all_blocks() if b.moe is not None)
    p = next(m for m in model.modules() if isinstance(m, moe.MoE))
    x = torch.randn(1, 6, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    y, aux = moe.moe(x, p, blk.moe, cfg, sp_dispatch=True)
    y0, aux0 = moe.moe(x, p, blk.moe, cfg)
    assert torch.equal(y, y0)
    assert all(torch.equal(aux[k], aux0[k]) for k in aux0)


@pytest.fixture(scope="module")
def dp_ep(tmp_path_factory):
    """The reference's olmoe Trainer on a (4, 1) mesh for 2 steps from its
    step-0 checkpoint, and the port's over 4 ranks from a copy of it."""
    base = tmp_path_factory.mktemp("dp_ep")
    ref = run_reference("trainers", 4, {"spec": OLMOE, "steps": 2,
                                        "modes": [False]}, base=base)["0"]
    ck = base / "port"
    shutil.copytree(ref["step0"], ck)
    port = run_ranks("trainer", 4, {"spec": OLMOE, "steps": 2,
                                    "ckpt": str(ck)}, base=base)
    return ref, port, ck


def _metrics(hist) -> list[dict]:
    """A history without its host times."""
    return [{k: v for k, v in h.items() if k not in ("dt", "straggler")}
            for h in hist]


def test_dp_ep_trainer_matches_reference(dp_ep):
    ref, port, _ = dp_ep
    got = [h["loss"] for h in port[0]["history"]]
    np.testing.assert_allclose(got, ref["losses"], rtol=1e-5)
    for res in port[1:]:
        assert _metrics(res["history"]) == _metrics(port[0]["history"])


def test_dp_ep_checkpoint_holds_every_expert(dp_ep):
    """Rank 0 writes the experts gathered from every rank: the step-2
    checkpoint has the reference's leaves and shapes, and its values are
    the reference's step-2 values."""
    ref, _, ck = dp_ep
    want_dir = ref["step0"].replace("step0_0", "run_0")
    name = "step_00000002.npz"
    with np.load(f"{want_dir}/{name}") as w, np.load(ck / name) as g:
        assert sorted(g.files) == sorted(w.files)
        experts = [k for k in w.files if "'moe'" in k and k.endswith(
            ("['wi']", "['wg']", "['wo']"))]
        assert experts
        for k in w.files:
            assert g[k].shape == w[k].shape, k
            if g[k].dtype.kind == "f":
                np.testing.assert_allclose(g[k], w[k], rtol=0,
                                           atol=PARAM_ATOL, err_msg=k)
            else:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
