"""The device's idle share of the traced window, in %: 1 - the union of
its operations' intervals over the window's length."""


def read(run):
    t = run.traced
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
