"""The Snake kernel's (K2, ``kernels/csrc/snake.cu``) share of its
roofline, in %: every Snake's bytes of a pass at the profile's dtypes
(``work.oneshot``) at 3.35 TB/s, times the passes traced, over the traced
device time of the kernels named ``snake``."""

from codec_bench import roofline


def read(run):
    t = run.traced
    if t is None or not t.units:
        return None
    spent = t.op_seconds("snake", exclude=("backward",))
    if spent <= 0:
        return None
    return 100.0 * t.units * run.work["snake_bytes"] / roofline.HBM_BYTES_PER_S / spent
