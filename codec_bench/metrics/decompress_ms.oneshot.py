"""Mean host milliseconds of a pass's decompress (codes and counts copied
in, the folded bfloat16 decoder, audio copied out, which synchronizes),
over the passes of the window."""


def read(run):
    spans = run.spans.get("decompress")
    return 1e3 * sum(spans) / len(spans) if spans else None
