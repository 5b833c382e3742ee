"""The port's checkpoint layout (``repro_torch.train.checkpoint``) on
nested states, against the JAX package's, on the CPU.

A state nests dicts, lists and tuples; its npz keys are the JAX package's
``tree_flatten_with_path`` names (``['params']|[0]``), so the sparsity
trainer's ``{"params": [...], "m": [...], "v": [...], "masks": [...]}``
state written by either package resumes in the other, bit for bit.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _repro_reference import reference
from repro_torch.train import SparseTrainConfig, SparseTrainer
from repro_torch.train import checkpoint as ckpt

KW = dict(sizes=(32, 24, 16, 10), steps=6, batch=16, seed=3, lam=0.05,
          prune_sparsity=0.5, finetune_steps=4, min_prune_size=1,
          ckpt_every=3)


@pytest.fixture(scope="module")
def ref():
    with reference() as ns:
        yield ns


def _state(rng) -> dict:
    return {"params": [rng.standard_normal((3, 4)).astype(np.float32),
                       rng.standard_normal((4, 2)).astype(np.float32)],
            "m": (np.zeros(2, np.float32), np.arange(3, dtype=np.int64)),
            "b": {"z": np.float64(2.5), "a": [np.ones((2, 2), np.float32),
                                              {"k": np.int32(7)}]},
            "gone": None}


def test_nested_state_round_trips(tmp_path):
    st = _state(np.random.default_rng(0))
    like = {"params": [torch.zeros(3, 4), torch.zeros(4, 2)],
            "m": (np.zeros(2, np.float32), np.zeros(3, np.int64)),
            "b": {"z": np.float64(0), "a": [torch.zeros(2, 2),
                                            {"k": np.int32(0)}]},
            "gone": None}
    ckpt.save(str(tmp_path), 4, st, extra={"losses": [1.5, 0.25]})
    got, step, extra = ckpt.restore(str(tmp_path), like)
    assert step == 4 and extra == {"losses": [1.5, 0.25]}
    assert sorted(got) == sorted(st) and got["gone"] is None
    assert isinstance(got["params"], list) and isinstance(got["m"], tuple)
    for a, b in zip(got["params"], st["params"]):
        assert isinstance(a, torch.Tensor) and np.array_equal(a.numpy(), b)
    for a, b in zip(got["m"], st["m"]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got["b"]["z"] == 2.5
    assert np.array_equal(got["b"]["a"][0].numpy(), st["b"]["a"][0])
    assert got["b"]["a"][1]["k"] == 7


def test_npz_keys_are_the_reference_path_names(ref, tmp_path):
    st = _state(np.random.default_rng(1))
    ckpt.save(str(tmp_path / "port"), 1, st)
    ref.checkpoint.save(str(tmp_path / "ref"), 1, st)
    with np.load(tmp_path / "port" / "step_00000001.npz") as a, \
            np.load(tmp_path / "ref" / "step_00000001.npz") as b:
        assert list(a.keys()) == list(b.keys())
        assert "['params']|[1]" in a.keys()
        assert "['b']|['a']|[1]|['k']" in a.keys()
        for k in a.keys():
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def _trainer_arrays(tr) -> list[np.ndarray]:
    return [np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor)
                       else x)
            for name in ("params", "opt_m", "opt_v", "masks")
            for x in getattr(tr, name)]


@pytest.mark.parametrize("stop", [3, 9])       # before and after the prune
def test_reference_trainer_checkpoint_resumes_in_the_port(ref, tmp_path,
                                                          stop):
    d = str(tmp_path / "ck")
    rt = ref.train_sparse.SparseTrainer(
        ref.train_sparse.SparseTrainConfig(ckpt_dir=d, **KW))
    rt.train(stop_after=stop)
    pt = SparseTrainer(SparseTrainConfig(ckpt_dir=d, **KW), device="cpu")
    state, step, extra = ckpt.restore(d, pt._state())
    assert step == stop and extra["losses"] == rt.losses
    pt.train(resume=True, stop_after=stop)          # restore, no step
    assert pt.step == stop and pt.losses == rt.losses
    for a, b in zip(_trainer_arrays(pt), _trainer_arrays(rt)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
    pt.train()
    assert pt.step == rt.cfg.total_steps


@pytest.mark.parametrize("stop", [3, 9])
def test_port_trainer_checkpoint_resumes_in_the_reference(ref, tmp_path,
                                                          stop):
    d = str(tmp_path / "ck")
    pt = SparseTrainer(SparseTrainConfig(ckpt_dir=d, **KW), device="cpu")
    pt.train(stop_after=stop)
    rt = ref.train_sparse.SparseTrainer(
        ref.train_sparse.SparseTrainConfig(ckpt_dir=d, **KW))
    rt.train(resume=True, stop_after=stop)
    assert rt.step == stop and rt.losses == pt.losses
    for a, b in zip(_trainer_arrays(rt), _trainer_arrays(pt)):
        assert np.array_equal(a, b)
    assert all(isinstance(m, jnp.ndarray) for m in rt.masks)
    with open(f"{d}/meta.json") as f:
        assert json.load(f)["latest_step"] == stop
