"""The median window latency (ms) over every window due in the window, from
when its last sample was due until its decoded segment left the decoder
pool (a window that never came counted at the run's end)."""


def read(run):
    return run.counters.get("latency_p50_ms")
