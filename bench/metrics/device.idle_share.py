"""device.idle_share: one minus the union of device activity over the
traced window, in % (source: device_trace)."""


def read(run):
    if run.profile is None or run.profile.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.profile.busy_s / run.profile.window_s)
