"""Host ms of issuing the kernels a poll: the self time of both pools'
``.launch`` spans (``stream_pool.poll.launch``, ``decoder_pool.poll.launch``)
in the polls of the untraced part, over its encoder polls that took windows
(each is followed by one decoder poll)."""

from codec_bench.program_spans import named, self_ms, under, window


def read(run):
    recs = window(run) or []
    enc, dec = named(recs, "stream_pool.poll"), named(recs, "decoder_pool.poll")
    if not enc:
        return None
    launches = (under(recs, enc, "stream_pool.poll.launch")
                + under(recs, dec, "decoder_pool.poll.launch"))
    return self_ms(launches, recs) / len(enc)
