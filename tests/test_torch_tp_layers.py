"""The port's tensor-parallel layers over gloo ranks on the CPU
(``tests/_torch_dist.py``), each block kind and each attention branch on 2
and 4 ranks of a ``(1, n)`` mesh, held to the port's one-rank layer and to
the JAX package's layer under ``jit`` on a (1, n) mesh of placeholder CPU
devices.

The cases (``_torch_dist.LAYER_CASES``): attention with its heads split
(branch a: granite at 2, olmoe with its qk-norm at 4), with K and V
gathered over head_dim (branch b: recurrentgemma's MQA at 2, granite's 2
KV heads at 4), context-parallel (branch c: phi3's 5 heads at 2 and 4,
and on an 11-token input that neither divides, where the queries, keys
and values are gathered over head_dim instead); the MLP; SSD (mamba2,
heads and channels split, the gated norm's mean over the group); RG-LRU
(its gates reading every channel); the MoE (experts' feed-forward split)
and its shared expert (kimi-k2).  Each case is one smoke block of the
arch's weights on a (2, 16) input ((2, 11) for the ragged case): its
output, the input's gradient and every parameter's gradient (gathered
whole) of ``sum(y * cot)``.

Tolerances, and why: everything within ``REL`` of the largest entry of
the array it is compared with (float32 sums split over ranks, or in
XLA's order; measured 1.4e-6 at most, the SSD ``dt_bias`` gradient).
"""

from __future__ import annotations

import numpy as np
import pytest

from _torch_dist import (LAYER_CASES, LAYER_S, TP_S, port_layer,
                         start_ranks, start_reference, write_inputs,
                         _port_model)

REL = 1e-5
CASES = [(kind, arch, n) for kind, pairs in LAYER_CASES.items()
         for arch, n in pairs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Rank 0's arrays of each case over 2 and 4 ranks, the reference's,
    and the inputs' directory."""
    base = tmp_path_factory.mktemp("tp_layers")
    inputs = write_inputs(sorted({a for _, a, _ in CASES}), base / "inputs")
    started = {}
    for n in (2, 4):
        args = {"inputs": inputs,
                "cases": [[k, a] for k, a, m in CASES if m == n]}
        started[n] = (start_reference("tp_layers", n, args, base=base),
                      start_ranks("tp_layers", n, args, base=base))
    out = {n: (ref.wait()["arrays"], port.wait()[0]["arrays"])
           for n, (ref, port) in started.items()}
    return out, inputs


def _close(got: dict, want: dict, prefix: str) -> None:
    keys = sorted(k for k in want if k.startswith(prefix))
    assert keys and keys == sorted(k for k in got if k.startswith(prefix))
    for k in keys:
        w = want[k]
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=REL * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


@pytest.mark.parametrize("kind,arch,n", CASES)
def test_layer_matches_reference_mesh(runs, kind, arch, n):
    (out, _) = runs
    want, got = out[n]
    _close(got, want, f"{kind}|{arch}|")


@pytest.mark.parametrize("kind,arch,n", CASES)
def test_layer_matches_one_rank(runs, kind, arch, n):
    """The port's layer over n ranks against the same layer without a
    group, in this process."""
    out, inputs = runs
    _, got = out[n]
    cfg, _, model, _ = _port_model(inputs, arch)
    y, dx, grads = port_layer(cfg, model, kind)
    key = f"{kind}|{arch}|"
    want = {f"{key}y": y, f"{key}dx": dx,
            **{f"{key}g|{k}": v for k, v in grads.items()}}
    _close(got, want, key)


def test_branches_are_the_ones_named():
    """The head counts of the cases give the branch each is named for."""
    from repro_torch.configs import registry
    for kind, arch, n in CASES:
        if not kind.startswith("attn"):
            continue
        cfg = registry.get(arch).smoke()
        head, kv = cfg.n_heads % n == 0, cfg.n_kv_heads % n == 0
        S = LAYER_S.get(kind, TP_S)
        assert {"attn_a": head and kv, "attn_b": head and not kv,
                "attn_c": not head and S % n == 0,
                "attn_c_ragged": not head and S % n != 0}[kind], \
            (kind, arch, n)


def test_one_rank_group_is_bit_identical(runs, tmp_path):
    """Every case over a group of one rank gives the bits of the path
    without a group in the same process (the collectives of one rank are
    exact copies, and the merges weigh one rank by exactly 1)."""
    _, inputs = runs
    cases = sorted({(k, a) for k, a, _ in CASES})
    got = start_ranks("tp_layers", 1, {"inputs": inputs, "plain": True,
                                       "cases": [list(c) for c in cases]},
                      base=tmp_path).wait()[0]["arrays"]
    plain = {k: v for k, v in got.items() if k.startswith("plain|")}
    assert len(plain) * 2 == len(got)
    for k, v in plain.items():
        assert np.array_equal(got[k[len("plain|"):]], v), k
