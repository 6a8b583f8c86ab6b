"""Mean host ms a step of the generator's losses, backward and update (the
program's ``train.gen_losses`` + ``train.gen_backward`` +
``train.gen_update`` spans in each ``train.step``; the update's clip waits
for the gradients' norm), over the steps of the untraced part."""

from codec_bench.program_spans import named, total_ms, under, window


def read(run):
    recs = window(run) or []
    steps = named(recs, "train.step")
    if not steps:
        return None
    phase = [r for n in ("train.gen_losses", "train.gen_backward", "train.gen_update")
             for r in under(recs, steps, n)]
    return total_ms(phase) / len(steps)
