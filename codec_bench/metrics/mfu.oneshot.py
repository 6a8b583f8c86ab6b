"""The whole pass's share of the card's peak, in %: the least time of a
pass (its float32 operations at 67 TFLOP/s plus its bfloat16 operations at
989 TFLOP/s, counted from the architecture by ``work.oneshot``) over the
measured time of a pass (the untraced part of the window over its
passes)."""

from codec_bench import roofline


def read(run):
    if not run.counters.get("rest_units") or "flops_f32" not in run.work:
        return None
    least = (run.work["flops_f32"] / roofline.F32_FLOP_PER_S
             + run.work["flops_bf16"] / roofline.BF16_FLOP_PER_S)
    return 100.0 * least / (run.counters["rest_s"] / run.counters["rest_units"])
