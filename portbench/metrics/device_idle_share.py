"""100% less the union of all device activity (kernels, memsets, copies)
over the traced window."""


def read(s, suffix):
    if suffix != s.kind or s.busy_s <= 0 or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
