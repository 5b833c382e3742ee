"""The island search spread over gloo ranks on the CPU
(``tests/_torch_dist.py``): 2 ranks x 2 islands against the one-process
4-island engine, which ``tests/test_torch_device_search.py`` holds to the
JAX package's engines.  The fc workload of the reference's search suite
(96-128-64), population 16, migration every 2 generations, 5
generations, snapshots every generation.

Each rank holds two consecutive islands; migration crosses ranks by
``ring_shift`` and the generation's stats are gathered and summed over
them.  Every snapshot must hold the one-process run's genomes and
objectives exactly, and a run resumes from the other layout's snapshots.
"""

from __future__ import annotations

import numpy as np
import pytest

from _torch_dist import ISLANDS, run_ranks
from repro_torch.core import resilience as R

GENS = ISLANDS["generations"]
KEYS = ("cores", "perm", "stage", "hot_mem", "hot_act", "times", "energies",
        "arch_cores", "arch_perm", "arch_times", "arch_energies")


def _snapshots(d) -> list[dict]:
    ck = R.SearchCheckpointer(str(d))
    return [ck.restore(g)[0] for g in range(ck.latest() + 1)]


def _same_snapshots(a, b, gens=range(GENS + 1)) -> None:
    for g in gens:
        for k in KEYS:
            assert np.array_equal(a[g][k], b[g][k]), (g, k)


def _same_result(a: dict, b: dict) -> None:
    for k in ("history", "candidate", "front", "n_evals"):
        assert a[k] == b[k], k


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("islands")
    one = run_ranks("islands", 1, {"dir": str(base / "one"),
                                   "group": False}, base=base)[0]
    two = run_ranks("islands", 2, {"dir": str(base / "two")}, base=base)
    return base, one, two


def test_two_ranks_visit_the_one_process_genomes(runs):
    base, one, two = runs
    assert len(one["history"]) == GENS + 1
    for res in two:
        _same_result(res, one)
    a, b = _snapshots(base / "one"), _snapshots(base / "two")
    assert len(a) == len(b) == GENS + 1
    _same_snapshots(a, b)


def test_resume_across_layouts(runs):
    """Two ranks killed after generation 2, resumed in one process; one
    process killed after generation 3, resumed over two ranks."""
    base, one, _ = runs
    want = _snapshots(base / "one")
    d = base / "two_to_one"
    crashed = run_ranks("islands", 2, {"dir": str(d), "kill_after": 2},
                        base=base)
    assert all(r["crashed"] for r in crashed)
    res = run_ranks("islands", 1, {"dir": str(d), "group": False,
                                   "resume": True}, base=base)[0]
    _same_result(res, one)
    _same_snapshots(_snapshots(d), want)
    d = base / "one_to_two"
    assert run_ranks("islands", 1, {"dir": str(d), "group": False,
                                    "kill_after": 3},
                     base=base)[0]["crashed"]
    for res in run_ranks("islands", 2, {"dir": str(d), "resume": True},
                         base=base):
        _same_result(res, one)
    _same_snapshots(_snapshots(d), want)


def test_a_group_belongs_to_the_sharded_engine():
    from repro_torch.core.search import evolutionary_search
    from _torch_dist import _search_workload
    net, chip, ev = _search_workload()
    for engine in ("numpy", "device"):
        with pytest.raises(ValueError, match="sharded"):
            evolutionary_search(net, chip, ev, engine=engine,
                                population_size=8, generations=1,
                                group=object())
