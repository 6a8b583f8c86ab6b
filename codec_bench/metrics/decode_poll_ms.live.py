"""Mean host ms of a ``DecoderPool.poll`` (the program's
``decoder_pool.poll`` span: stacking codes and stage masks, the copies in,
issuing the decoder, the wait for the device and the copy out), over the
polls of the untraced part."""

from codec_bench.program_spans import named, total_ms, window


def read(run):
    polls = named(window(run) or [], "decoder_pool.poll")
    return total_ms(polls) / len(polls) if polls else None
