"""Windows that each ``StreamPool.poll`` of the window returned, mean over
the polls that returned any (counted by the benchmark)."""


def read(run):
    return run.counters.get("pool_rows") or None
