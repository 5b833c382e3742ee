"""compute.host_ms_per_step: host milliseconds per simulated step inside
the network's calls into the layer-compute backend (``EventCompute``'s
``forward``, ``delta_forward`` and ``value_forward``, through the
benchmark's subclass), over the ``--trace 1`` run's window (source:
program_span)."""


def read(run):
    jobs = set(range(run.window_jobs))
    compute = sum(t1 - t0 for n, t0, t1, j in run.spans.items
                  if n.startswith("compute.") and j in jobs)
    if not jobs or compute <= 0:
        return None
    return 1e3 * compute / (run.steps * len(jobs))
