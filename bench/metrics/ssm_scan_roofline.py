"""ssm_scan_roofline: the traced jobs' ssm state-neuron scans at their
bound, as a share of the device time of the kernel that ran them, in %
(source: device_trace).

The bound is the bytes the scans need (``bench/scan_counting.py``) over
3.35 TB/s; the device time is that of the kernels whose names hold
``ssm_scan`` in the profiler's trace of the same jobs.  None where the
program runs no such kernel or the cell has no ``ssm`` layer."""

from bench import counting, scan_counting


def read(run):
    if run.profile is None:
        return None
    seconds = run.profile.device_seconds(("ssm_scan",))
    nbytes = scan_counting.traced_bytes(run.cell.config, run.cell.traffic)
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / counting.PEAK_BYTES_PER_S / seconds
