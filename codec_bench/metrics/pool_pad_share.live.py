"""Padding rows over the rows sent to the card, both pools, in %: the
``.put`` spans' payloads (rows, padding included) against their polls'
(windows), over the polls of the untraced part."""

from codec_bench.program_spans import named, under, window


def read(run):
    recs = window(run) or []
    windows = rows = 0
    for pool in ("stream_pool.poll", "decoder_pool.poll"):
        polls = named(recs, pool)
        windows += sum(p.payload for p in polls)
        rows += sum(r.payload for r in under(recs, polls, pool + ".put"))
    return 100.0 * (rows - windows) / rows if rows else None
