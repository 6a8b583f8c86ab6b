"""Mean host milliseconds of a pass's compress (copy in, encoder,
importance subnet, fused codebook kernel, codes and counts copied out,
which synchronizes), over the passes of the window."""


def read(run):
    spans = run.spans.get("compress")
    return 1e3 * sum(spans) / len(spans) if spans else None
