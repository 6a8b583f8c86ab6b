"""Mean host ms of a ``StreamPool.poll`` that took windows (the program's
``stream_pool.poll`` span: stacking, the copy in, issuing the encoder, the
importance subnet and the codebook kernel, the wait for the device and the
copy out), over the polls of the untraced part."""

from codec_bench.program_spans import named, total_ms, window


def read(run):
    polls = named(window(run) or [], "stream_pool.poll")
    return total_ms(polls) / len(polls) if polls else None
