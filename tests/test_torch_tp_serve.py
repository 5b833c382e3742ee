"""The port's tensor-parallel serving over 4 gloo ranks on the CPU
(``tests/_torch_dist.py``), held to the JAX package's ``lm.prefill`` /
``lm.decode_step`` loop under ``jit`` on a (1, 4) mesh of placeholder CPU
devices (its ``Engine`` has reference faults 1 and 2, so the loop places
the prefill cache itself, at slot ``p % W``).

Seven archs in float32 (weights of the port's ``init_params(cfg, 0)``):
an 11-token prompt of 2 rows, the prefill's logits and 8 greedy decode
steps.  phi3's 5 heads do not divide the group and 11 tokens do not
either: its prefill runs branch (c)'s replicated fallback, its decode
gathers the query and the new K/V over head_dim.  The port serves through ``Engine(..., mesh=(1, 4))``: the model
placed by ``shard_params``, the attention caches' 19 slots padded to a
ring of 20, 5 a rank (gemma2's and recurrentgemma's window blocks hold 8,
2 a rank), flash-decoding merges.  whisper decodes its prompt token by
token against the whole cross-attention cache.  And the engine on
(1, 4) equals its own teacher forcing where decode crosses gemma2's
window (prompt 5, window 8, 10 new tokens).

Tolerances, and why: tokens exactly (greedy, the margins are far above
roundoff); logits within ``LOGIT_ATOL`` (float32 sums split over ranks
against XLA's order).
"""

from __future__ import annotations

import numpy as np
import pytest

from _torch_dist import (SERVE, SERVE_ARCHS, start_ranks, start_reference,
                         write_inputs)

LOGIT_ATOL = 5e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("tp_serve")
    inputs = write_inputs(SERVE_ARCHS, base / "inputs")
    args = {"inputs": inputs, "archs": SERVE_ARCHS}
    ref = start_reference("tp_serve", 4, args, base=base)
    port = start_ranks("tp_serve", 4, {**args, "window": True},
                       base=base).wait()
    return ref.wait(), port


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_prefill_and_decode_match_reference(runs, arch):
    ref, port = runs
    want = ref["tokens"][arch]
    assert np.array(want).shape == (SERVE["B"], SERVE["new"] + 1)
    for res in port:                    # every rank samples the same
        assert res["tokens"][arch] == want
    got, w = port[0]["arrays"][arch], ref["arrays"][arch]
    assert got.shape == w.shape
    np.testing.assert_allclose(got, w, rtol=0, atol=LOGIT_ATOL,
                               err_msg=arch)


def test_decode_across_the_window_matches_teacher_forcing(runs):
    _, port = runs
    for res in port:
        w = res["window"]
        assert len(w["engine"]) == 10 and w["engine"] == w["forced"]
