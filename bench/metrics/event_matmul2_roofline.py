"""event_matmul2_roofline: the traced jobs' event-matmul products at
their bound, as a share of the device time of the kernels that computed
them, in % (source: device_trace).

Each product's bound is the larger of its needed operations over the
peak of its kind (float32 values at 495 TFLOP/s, int8 counts at 1,979
TOP/s) and its needed bytes over 3.35 TB/s (``bench/counting.py``); the
device time is that of ``event_matmul_kernel`` and ``reduce_splits``
in the profiler's trace of the same jobs."""

from bench import harness


def read(run):
    if run.profile is None or not run.needs:
        return None
    seconds = run.profile.device_seconds(harness.EVENT_MATMUL_KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * sum(n.seconds for n in run.needs) / seconds
