"""The one stream generator every traffic mix goes through.

A traffic file (``bench/traffic/<name>.json``) gives the job's stream and
how the window drives it:

``steps``             simulated timesteps (tokens) of one stream
``streams_per_job``   streams a job runs back to back, ended by one
                      synchronise (each a ``run_batch`` of its own)
``seq_len``           the decode context the frontend compiles for
``recurrent_neuron``  the frontend's neuron model for state layers
``act_density``       a programmed message density (null: none)
``warm_jobs``         jobs run in set-up, before the window
``trace_jobs``        jobs under the profiler in a ``--trace 1`` run

Every input is ``|N(VALUE_MEAN, VALUE_STD)|``: a dense stream.
``correct`` judges ``CHECK_STREAMS`` streams drawn from the seed among
those of the first ``CHECK_RANGE`` jobs.

Stream ``s`` of job ``j`` has the id ``j * streams_per_job + s``; each
stream is drawn on the device from its own ``torch.Generator``,
seeded from ``(seed, id)``, so the reference can draw it again.  The
program never sees the seed, only the stream.  The generator is the
benchmark's own: the port's ``make_inputs`` (numpy on the host, commit
cbf4587) is not used.
"""

from __future__ import annotations

import numpy as np
import torch

VALUE_MEAN, VALUE_STD = 1.0, 0.2
CHECK_STREAMS, CHECK_RANGE = 2, 50
DEFAULTS = {"streams_per_job": 1, "act_density": None, "warm_jobs": 3,
            "trace_jobs": 3}


def with_defaults(traffic: dict) -> dict:
    return {**DEFAULTS, **traffic}


def stream_seed(seed: int, sid: int) -> int:
    """A 63-bit generator seed for stream ``sid`` of run ``seed``."""
    state = np.random.SeedSequence([int(seed), int(sid)]).generate_state(
        1, np.uint64)[0]
    return int(state) >> 1


def stream(traffic: dict, d_model: int, seed: int, sid: int,
           device: torch.device) -> torch.Tensor:
    """Stream ``sid``'s (steps, d_model) float32 input stream on
    ``device``: ``|N(VALUE_MEAN, VALUE_STD)|`` values."""
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, sid))
    x = torch.randn((int(traffic["steps"]), int(d_model)), generator=g,
                    device=device, dtype=torch.float32)
    return (x * VALUE_STD + VALUE_MEAN).abs()


def checked_streams(traffic: dict, seed: int) -> list[int]:
    """The streams whose answers ``correct`` judges: ``CHECK_STREAMS``
    distinct ids drawn from the seed among the first ``CHECK_RANGE``
    jobs' streams."""
    t = with_defaults(traffic)
    rng = np.random.default_rng([int(seed), 7])
    n_ids = CHECK_RANGE * int(t["streams_per_job"])
    n = min(CHECK_STREAMS, n_ids)
    return sorted(int(j) for j in rng.choice(n_ids, n, replace=False))
