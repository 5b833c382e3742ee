"""sim_step.mfu: the window's jobs as a share of the card's peak, in %.

Two operations per MAC that the jobs' value products need, as the
reference counts them (its ``macs`` counters of the checked jobs), times
the jobs completed in the ``--trace 1`` run's window, over that window's
host-clock seconds, over the float32-as-TF32 peak of 495 TFLOP/s
(``bench/counting.py``).  The counter products are bookkeeping and are
not counted."""

from bench import counting


def read(run):
    if not run.macs_per_job or not run.window_jobs:
        return None
    flops = counting.job_flops(run.macs_per_job) * run.window_jobs
    return counting.mfu_percent(flops, run.window_s)
