"""network.self_ms_per_step: host milliseconds per simulated step inside
``run_batch`` that no layer-compute call covers (the neuron recurrence,
the counters' glue), over the ``--trace 1`` run's window (source:
program_span)."""

from bench import tracing


def read(run):
    jobs = set(range(run.window_jobs))
    job = sum(t1 - t0 for n, t0, t1, j in run.spans.items
              if n == tracing.RUN_BATCH_SPAN and j in jobs)
    compute = sum(t1 - t0 for n, t0, t1, j in run.spans.items
                  if n.startswith("compute.") and j in jobs)
    if not jobs or job <= 0:
        return None
    return 1e3 * (job - compute) / (run.steps * len(jobs))
