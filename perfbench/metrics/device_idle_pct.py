"""device_idle_pct (%): the share of the profiled pass's window in which
no operation ran on the device, from the profiler's timeline."""


def read(s):
    if s.window_s <= 0 or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
