"""device_idle_pct.view: the share of the traced window in which neither
a kernel nor a copy runs on the device, in %."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.window_s)
