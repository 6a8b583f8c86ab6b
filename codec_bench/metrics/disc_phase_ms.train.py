"""Mean host ms a step of the generator's forward and the discriminator's
update (the program's ``train.forward`` + ``train.disc`` spans in each
``train.step``; the update's clip waits for the gradients' norm, so the
phase ends when the device has done it), over the steps of the untraced
part."""

from codec_bench.program_spans import named, total_ms, under, window


def read(run):
    recs = window(run) or []
    steps = named(recs, "train.step")
    if not steps:
        return None
    phase = under(recs, steps, "train.forward") + under(recs, steps, "train.disc")
    return total_ms(phase) / len(steps)
