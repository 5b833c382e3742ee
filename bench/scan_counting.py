"""The bytes that the ssm state neurons' scan needs.

In a stream of T steps, each state layer of width n whose neuron model
is ``ssm`` reads its (T, n) float32 pre-activations once and writes its
(T, n) messages once, and reads and writes its n-wide state once:
``2 * T * n * 4 + 2 * n * 4`` bytes.  The layers are those of the
frozen lowering (``bench/lowering.py``), so a change to the program's
frontend does not move the count.
"""

from __future__ import annotations

from bench import lowering, traffic

FLOAT_BYTES = 4


def stream_bytes(config: dict, tr: dict) -> int:
    """Bytes the scans of one stream of the mix ``tr`` need."""
    T = int(tr["steps"])
    specs = lowering.lowering_spec(config, seq_len=int(tr["seq_len"]),
                                   recurrent_neuron=tr["recurrent_neuron"])
    return sum(2 * (T + 1) * s.width * FLOAT_BYTES for s in specs
               if s.neuron_model == "ssm")


def traced_bytes(config: dict, tr: dict) -> int:
    """Bytes the scans of a ``--trace 1`` run's profiled jobs need:
    ``trace_jobs`` jobs of ``streams_per_job`` streams."""
    t = traffic.with_defaults(tr)
    return (stream_bytes(config, t) * int(t["trace_jobs"])
            * int(t["streams_per_job"]))
