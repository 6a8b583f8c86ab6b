"""Mean wait (ms) of a window in ``StreamPool``'s queue, from the ``push``
that completed it to the start of the poll that took it (the program's
``stream_pool.wait`` records), over the windows of the untraced part."""

from codec_bench.program_spans import named, total_ms, window


def read(run):
    waits = named(window(run) or [], "stream_pool.wait")
    return total_ms(waits) / len(waits) if waits else None
