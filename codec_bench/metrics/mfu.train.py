"""The whole step's share of the card's float32 peak, in %: the operations
of every step of the window (``work.train_step``: the generator's forward
and backward, the discriminator's forwards and backward, counted from the
architecture) over 67 TFLOP/s times the cards times the window (its
untraced part)."""

from codec_bench import roofline


def read(run):
    if not run.counters.get("rest_units") or "step_flops" not in run.work:
        return None
    return (100.0 * run.counters["rest_units"] * run.work["step_flops"]
            / (roofline.F32_FLOP_PER_S * run.chips * run.counters["rest_s"]))
