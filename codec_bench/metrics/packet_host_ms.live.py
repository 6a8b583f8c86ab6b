"""Host ms of range coding a window: ``PacketCodec.pack`` and ``unpack``
(the program's ``packet.pack`` and ``packet.unpack`` spans) over the
untraced part, over the packets packed."""

from codec_bench.program_spans import named, total_ms, window


def read(run):
    recs = window(run) or []
    packs = named(recs, "packet.pack")
    return total_ms(packs + named(recs, "packet.unpack")) / len(packs) if packs else None
