"""Share of the traced slice in which no operation ran on the device."""


def read(s):
    return 100.0 * (1.0 - s.busy_s / s.window_s) if s.window_s > 0 and s.busy_s > 0 else None
