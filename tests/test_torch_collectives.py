"""The port's collectives, meshes, asynchronous and elastic checkpoints and
the launcher over gloo ranks on the CPU (``tests/_torch_dist.py``), held to
the JAX package's collectives on placeholder CPU devices.

Tolerances, and why:

* the compressed mean over 4 ranks bit for bit against the reference's
  under ``shard_map`` on 4 devices (an int32 sum, a max, and a product by
  1/4, all exact); the error within an ulp of the leaf's largest value
  over all ranks (XLA contracts ``x - q * scale`` into one FMA, the port
  rounds the product first, as ``tests/test_torch_optim.py`` bounds it;
  the product is as large as the largest value of any rank, since the
  scale is the ranks' largest);
* everything else exact.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist import ROOT, run_ranks, run_reference
from repro_torch.distributed import collectives as C
from repro_torch.train import checkpoint as ckpt_lib


@pytest.fixture(scope="module")
def ref_compressed(tmp_path_factory):
    return run_reference("compressed", 4,
                         base=tmp_path_factory.mktemp("ref"))


@pytest.mark.parametrize("n", [2, 4])
def test_ring_shift_and_gather_islands_over_ranks(n, tmp_path):
    """Rank ``r`` receives rank ``r - 1``'s rows, a shift back restores
    every rank's own, the rows' multiset is kept; ``gather_islands``
    stacks (n, ...) and tiles (n * rows, ...) in rank order."""
    out = run_ranks("collectives", n, base=tmp_path)
    own = [np.arange(6, dtype=np.int32).reshape(3, 2) + 100 * r
           for r in range(n)]
    for r, res in enumerate(out):
        a = res["arrays"]
        np.testing.assert_array_equal(a["shifted_cores"], own[(r - 1) % n])
        np.testing.assert_array_equal(a["shifted_times"],
                                      np.full(3, float((r - 1) % n)))
        assert bool(a["back_equal"])
        np.testing.assert_array_equal(a["stacked_cores"], np.stack(own))
        np.testing.assert_array_equal(a["tiled_cores"],
                                      np.concatenate(own))
    shifted = sorted(map(tuple, np.concatenate(
        [res["arrays"]["shifted_cores"] for res in out])))
    assert shifted == sorted(map(tuple, np.concatenate(own)))


def test_compressed_mean_matches_reference_on_four_devices(ref_compressed,
                                                           tmp_path):
    out = run_ranks("collectives", 4,
                    {"compressed": ref_compressed["inputs"]}, base=tmp_path)
    want = ref_compressed["arrays"]
    with np.load(ref_compressed["inputs"]) as f:
        g = {k: f[k] for k in f.files}
    for r, res in enumerate(out):
        got = res["arrays"]
        for i in range(2):
            for k in ("a", "b"):
                np.testing.assert_array_equal(got[f"mean{i}_{k}"],
                                              want[f"mean{i}_{k}"][r])
                # one rounding of q * gmax, |q * gmax| <= max over the
                # ranks of |g + err| (the fed-back err is at most half a
                # step, gmax / 2 < max|g| / 127)
                np.testing.assert_allclose(
                    got[f"err{i}_{k}"], want[f"err{i}_{k}"][r], rtol=0,
                    atol=2.0 ** -23 * (1 + 1 / 127)
                    * np.abs(g[k] * (1 + i)).max())
    # every replica holds the same mean
    for res in out[1:]:
        np.testing.assert_array_equal(res["arrays"]["mean1_a"],
                                      out[0]["arrays"]["mean1_a"])


def test_one_rank_group_is_the_one_replica_mean(ref_compressed, tmp_path):
    """A group of one rank gives the bits of the call without a group."""
    got = run_ranks("collectives", 1,
                    {"compressed": ref_compressed["inputs"]},
                    base=tmp_path)[0]["arrays"]
    with np.load(ref_compressed["inputs"]) as f:
        g = {k: torch.from_numpy(f[k][0]) for k in ("a", "b")}
    err = C.init_error_feedback(g)
    for i in range(2):
        mean, err = C.compressed_grad_mean({k: v * (1 + i)
                                            for k, v in g.items()}, err)
        for k in g:
            np.testing.assert_array_equal(got[f"mean{i}_{k}"],
                                          mean[k].numpy())
            np.testing.assert_array_equal(got[f"err{i}_{k}"],
                                          err[k].numpy())


def test_make_mesh_over_ranks(tmp_path):
    out = run_ranks("mesh", 2, base=tmp_path)
    for r, res in enumerate(out):
        assert res["axes"] == ["data", "model"]
        assert res["sizes"] == {"data": 2, "model": 1}
        assert res["coords"] == {"data": r, "model": 0}
        assert (res["data_group_size"], res["model_group_size"]) == (2, 1)
        assert res["ctx_dp_size"] == res["ctx_dp_group_size"] == 2
        refused = res["refused"]
        assert "has 2" in refused["(1, 1)"]
        assert "needs 4 ranks" in refused["(2, 2)"]
        assert "has 2" in refused["(4, 1)"]


def test_tensor_parallel_meshes_over_four_ranks(tmp_path):
    """(2, 2) and (1, 4) over 4 ranks: rank ``d * m + j`` sits at data
    coordinate ``d`` and model coordinate ``j``; each axis has a group of
    its size, and the context's data and model groups are those."""
    out = run_ranks("mesh", 4, base=tmp_path)
    for r, res in enumerate(out):
        for shape in ((2, 2), (1, 4)):
            got = res["tp"][str(shape)]
            d, m = shape
            assert got["sizes"] == {"data": d, "model": m}
            assert got["coords"] == {"data": r // m, "model": r % m}
            assert (got["data_group_size"], got["model_group_size"]) \
                == (d, m)
            assert (got["ctx_dp_group_size"], got["ctx_tp_group_size"],
                    got["ctx_tp_rank"]) == (d, m, r % m)


def test_one_device_mesh_needs_no_group():
    from repro_torch.launch.mesh import make_mesh, mesh_of
    m = make_mesh((1, 1), ("data", "model"))
    assert m == ("data", "model") and m.sizes == {"data": 1, "model": 1}
    assert m.groups == {"data": None, "model": None}
    assert mesh_of(None) is None and mesh_of(m) is m
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh((2, 1), ("data", "model"))
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_mesh((1, 4), ("data", "model"))


def _state():
    rng = np.random.default_rng(0)
    return {"params": {"w": torch.from_numpy(rng.standard_normal(
                (3, 4)).astype(np.float32)).to(torch.bfloat16),
                       "b": torch.from_numpy(rng.standard_normal(5))},
            "step": torch.tensor(7, dtype=torch.int32),
            "lst": [np.arange(3), None]}


def test_save_async_writes_the_files_of_save(tmp_path):
    state = _state()
    ckpt_lib.save(str(tmp_path / "sync"), 3, state, extra={"data_step": 3})
    t = ckpt_lib.save_async(str(tmp_path / "async"), 3, state,
                            extra={"data_step": 3})
    # the snapshot is taken before the call returns
    state["params"]["b"].add_(1.0)
    t.join()
    assert sorted(os.listdir(tmp_path / "sync")) \
        == sorted(os.listdir(tmp_path / "async"))
    assert (tmp_path / "sync" / "meta.json").read_text() \
        == (tmp_path / "async" / "meta.json").read_text()
    name = "step_00000003.npz"
    with np.load(tmp_path / "sync" / name) as a, \
            np.load(tmp_path / "async" / name) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            assert a[k].tobytes() == b[k].tobytes(), k


def test_restore_places_leaves_on_their_targets(tmp_path):
    """``shardings``: a device per leaf (None keeps the like-leaf's); the
    dtype is the like-leaf's, or the file's for a host leaf."""
    state = _state()
    ckpt_lib.save(str(tmp_path), 1, state)
    like = {"params": {"w": torch.empty((), dtype=torch.bfloat16),
                       "b": torch.empty((), dtype=torch.float64)},
            "step": torch.empty((), dtype=torch.int32),
            "lst": [np.zeros(1, np.int64), None]}
    targets = {"params": {"w": "cpu", "b": None}, "step": "cpu",
               "lst": ["cpu", None]}
    got, step, _ = ckpt_lib.restore(str(tmp_path), like, shardings=targets)
    assert step == 1
    assert torch.equal(got["params"]["w"], state["params"]["w"])
    assert torch.equal(got["params"]["b"], state["params"]["b"])
    assert got["params"]["w"].device.type == "cpu"
    assert isinstance(got["lst"][0], torch.Tensor)
    np.testing.assert_array_equal(got["lst"][0].numpy(), np.arange(3))
    assert got["lst"][1] is None and int(got["step"]) == 7


def test_launcher_trains_data_parallel_under_torchrun(tmp_path):
    """``torchrun --nproc-per-node 2`` starts the launcher on gloo: the
    mesh is (2, 1), rank 0 alone logs and writes the checkpoints."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    ck = tmp_path / "ck"
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "granite-3-2b", "--smoke", "--steps", "2", "--batch",
         "4", "--seq", "16", "--device", "cpu", "--ckpt-dir", str(ck)],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=240)
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.splitlines()
    assert sum(l.startswith("final loss: ") for l in lines) == 1
    assert sum(l.startswith("[trainer] step 2 ") for l in lines) == 1
    assert ckpt_lib.latest_step(str(ck)) == 2
    meta = json.loads((ck / "meta.json").read_text())
    assert meta["extra"] == {"data_step": 2}
