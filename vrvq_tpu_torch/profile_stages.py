"""Device time of the codec's stages on the card, packed and unpacked.

``python -m vrvq_tpu_torch.profile_stages [--out PATH]`` builds the
flagship codec (random seeded weights) and runs its encoder and decoder one
shot on ``BATCH`` (16) seeded clips of ``CLIP_S`` (10) seconds, the JAX
package's serving shape, stage by stage: the in conv, ``block_0`` to
``block_3`` and the tail (Snake and out conv) of each stack, and the whole
stack. It does so for

  * the encoder of the turbo profile (float32, the polynomial Snake),
    unpacked and with the time-packed first stage (``encode_packed``);
  * the fast profile's folded decoder, in float32 and in bfloat16 (the
    polynomial Snake), unpacked, with the last one or two blocks and the
    tail packed (``decode_packed`` 1, 2) and with only the last blocks'
    transposed convs packed (``decode_packed_up`` 1, 2).

For each stage: the device ms (CUDA events recorded on the stream before and
after it, the median of ``RUNS`` runs after a warm-up), the MACs of its
convs as they run (a packed conv's dense kernel, structured zeros included)
and the bytes its convs, Snakes and residual adds must move (each input read
once, each output written once), both reckoned from the shapes, and the
share of the card's peak that fits the dtype: float32 outside the tensor
cores 67 TFLOP/s (TF32 is off), bfloat16 dense 989 TFLOP/s, HBM 3.35 TB/s
(H100 SXM data sheet). This is the counterpart of the JAX package's
``scripts/profile_encoder.py``. Prints one JSON line (and writes it to
``--out``). Needs an NVIDIA card.

``memory_gib`` holds what each stack, built and run, still holds on the
card and the most it held while it ran (its parameters and the packed
kernels, which every packed module derives at each call).

The encoder's input packing (a reshape and a copy of the (B, 1, T) audio)
and the decoder's unpacking and tanh fall outside the stages; ``total``
holds them.


``conv_census`` (which ``chip_smoke.py``'s fast phase prints) times each
conv geometry of the fast profile's bfloat16 decoder alone, in (B, C, T)
and channels-last as the decoder runs it.
"""

from __future__ import annotations

import argparse
import collections
import functools
import json
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

BATCH = 16
CLIP_S = 10.0
RUNS = 3
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
STAGES = ("in_conv", "block_0", "block_1", "block_2", "block_3", "tail")
DECODER_VARIANTS = {"unpacked": {}, "decode_packed_1": dict(decode_packed=1),
                    "decode_packed_2": dict(decode_packed=2),
                    "decode_packed_up_1": dict(decode_packed_up=1),
                    "decode_packed_up_2": dict(decode_packed_up=2)}


def conv_work(module, x: torch.Tensor, y: torch.Tensor):
    """(MACs, bytes) of one weight-normed conv call as it runs."""
    from .nn.layers import WNConvTranspose1d

    weight = module.w if module.folded else module.v
    if module.packed:
        co, ci, taps = module.packed_kernel_shape()
        macs = y.shape[0] * y.shape[-1] * co * ci * taps
        w_numel = co * ci * taps
    elif isinstance(module, WNConvTranspose1d):
        ci, co, k = weight.shape
        macs = x.shape[0] * x.shape[-1] * ci * co * k
        w_numel = weight.numel()
    else:
        co, ci, k = weight.shape
        macs = y.shape[0] * y.shape[-1] * co * ci * k
        w_numel = weight.numel()
    size = x.element_size()
    return macs, size * (x.numel() + y.numel() + w_numel + y.shape[1])


class StageClock:
    """CUDA events before and after each named stage module, and the MACs
    and bytes of the convs, Snakes and residual adds inside each."""

    def __init__(self, stack: torch.nn.Module):
        from .nn.layers import ResidualUnit, Snake1d, WNConv1d, WNConvTranspose1d

        self.events = {}
        self.work = {}
        self.hooks = []
        self.counting = False
        stages = {name: getattr(stack, name) for name in STAGES[:-1]}
        stages["tail"] = (stack.snake, stack.out_conv)
        for name, mods in stages.items():
            first, last = (mods if isinstance(mods, tuple) else (mods, mods))
            self.hooks.append(first.register_forward_pre_hook(self._mark(name, 0)))
            self.hooks.append(last.register_forward_hook(self._mark(name, 1)))
            for top in (mods if isinstance(mods, tuple) else (mods,)):
                for m in top.modules():
                    if isinstance(m, (WNConv1d, WNConvTranspose1d, Snake1d, ResidualUnit)):
                        self.hooks.append(m.register_forward_hook(self._count(name)))

    def _mark(self, name, end):
        def hook(module, args, out=None):
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.events.setdefault(name, [None, None])[end] = event
        return hook

    def _count(self, name):
        from .nn.layers import ResidualUnit, Snake1d

        def hook(module, args, out):
            if not self.counting:
                return
            x = args[0]
            macs, moved = 0, 0
            if isinstance(module, Snake1d):
                moved = 2 * x.numel() * x.element_size()
            elif isinstance(module, ResidualUnit):
                moved = 3 * out.numel() * out.element_size()
            else:
                macs, moved = conv_work(module, x, out)
            w = self.work.setdefault(name, [0, 0])
            w[0] += macs
            w[1] += moved
        return hook

    def times(self) -> dict:
        torch.cuda.synchronize()
        return {name: a.elapsed_time(b) for name, (a, b) in self.events.items()}

    def close(self) -> None:
        for h in self.hooks:
            h.remove()


def memory_gib(before: int) -> dict:
    """The GiB a stack built and run since ``before`` (the bytes allocated
    then) still holds (``held``: its parameters, buffers and cached index
    maps) and the most it held while it ran (``peak``)."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    peak = torch.cuda.max_memory_allocated() - before
    torch.cuda.reset_peak_memory_stats()
    return {"held": held / 2 ** 30, "peak": peak / 2 ** 30}


def profile_stack(stack, fn, dtype: torch.dtype) -> dict:
    """Per-stage and total device ms of ``fn()`` (one forward of ``stack``),
    medians of ``RUNS`` after a warm-up that also counts the work."""
    clock = StageClock(stack)
    try:
        clock.counting = True
        fn()
        clock.counting = False
        torch.cuda.synchronize()
        per_run = []
        for _ in range(RUNS):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            end.record()
            per_run.append({**clock.times(), "total": start.elapsed_time(end)})
    finally:
        clock.close()
    rows = {}
    for name in (*STAGES, "total"):
        ms = statistics.median(r[name] for r in per_run)
        if name == "total":
            macs, moved = (sum(w[i] for w in clock.work.values()) for i in (0, 1))
        else:
            macs, moved = clock.work.get(name, (0, 0))
        flop_ms = 2 * macs / PEAK_FLOP_PER_S[dtype] * 1e3
        byte_ms = moved / HBM_BYTES_PER_S * 1e3
        rows[name] = {"ms": ms, "macs": macs, "bytes": moved,
                      "flop_share": flop_ms / ms, "byte_share": byte_ms / ms,
                      "bound_ms": max(flop_ms, byte_ms),
                      "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}
    return rows


def _layout_row(fn, runs: int) -> dict:
    """``fn()`` on the card: the median device ms of ``runs`` calls (CUDA
    events around each, after a warm-up) and the device kernels of one
    traced call, longest first (name, ms)."""
    from . import utils

    fn()
    times = []
    for _ in range(runs):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = collections.Counter()
    for name, on_device, annotation, begin, finish in utils.profile_events(prof):
        if utils.is_device_op(name, on_device, annotation):
            kernels[name[:100]] += (finish - begin) / 1e6
    return {"ms": statistics.median(times),
            "kernels": [[k, v] for k, v in kernels.most_common()]}


def conv_census(decoder, z: torch.Tensor, runs: int = RUNS) -> list:
    """Each distinct conv geometry of ``decoder`` (unpacked, folded) on the
    latents ``z``: where it sits (the first module of that geometry), its
    calls a decode, its bound (bfloat16 operations at 989 TFLOP/s or input,
    kernel and output bytes at 3.35 TB/s, the larger) and, on random inputs
    of its shapes in the decoder's dtype, ``_layout_row`` in (B, C, T)
    (``conv1d`` / ``conv_transpose1d``) and channels-last as the decoder
    runs it (``nn/layers.conv_last``, in the form ``conv_form`` names),
    with ``err_ulps``, the largest difference of the channels-last output
    from the plain conv (float32 sums rounded once) in units of one
    bfloat16 rounding (2^-7 of the plain value, plus 1e-5 of its largest):
    at most 1 where the two agree."""
    from .nn.layers import (WNConv1d, WNConvTranspose1d, conv_form, conv_last,
                            to_channels_last)

    seen = {}

    def hook(name):
        def record(module, args):
            key = (isinstance(module, WNConvTranspose1d), tuple(args[0].shape),
                   tuple(module.w.shape), module.stride, module.padding,
                   getattr(module, "dilation", 1))
            seen.setdefault(key, [name, 0])[1] += 1
        return record

    hooks = [m.register_forward_pre_hook(hook(n)) for n, m in decoder.named_modules()
             if isinstance(m, (WNConv1d, WNConvTranspose1d))]
    try:
        decoder(z)
    finally:
        for h in hooks:
            h.remove()
    dtype = decoder.dtype
    rows = []
    for (transposed, xs, ws, stride, pad, dil), (name, calls) in seen.items():
        gen = torch.Generator(device=z.device).manual_seed(len(rows))
        x = torch.randn(xs, generator=gen, device=z.device).to(dtype)
        w = (0.02 * torch.randn(ws, generator=gen, device=z.device)).to(dtype)
        xl, wl = to_channels_last(x), to_channels_last(w)
        if transposed:
            cin, cout, k = ws
            t_out = (xs[-1] - 1) * stride - 2 * pad + k
            macs = xs[-1] * cin * cout * k
            plain = functools.partial(F.conv_transpose1d, stride=stride, padding=pad)
            form = "nhwc"
        else:
            cout, cin, k = ws
            t_out = (xs[-1] + 2 * pad - dil * (k - 1) - 1) // stride + 1
            macs = t_out * cout * cin * k
            plain = functools.partial(F.conv1d, stride=stride, padding=pad,
                                      dilation=dil)
            form = conv_form(cout, stride, pad, dil)
        cl = functools.partial(conv_last, xl, wl, stride, pad, dil,
                               transposed=transposed)
        batch = xs[0]
        moved = x.element_size() * (x.numel() + w.numel() + batch * cout * t_out)
        flop_ms = 2 * batch * macs / PEAK_FLOP_PER_S[dtype] * 1e3
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            want = plain(x.float(), w.float()).to(dtype).float()
        scale = 2.0 ** -7 * want.abs() + 1e-5 * want.abs().max()
        err = ((cl().float() - want).abs() / scale).max().item()
        del want, scale
        rows.append({"conv": name, "calls": calls, "transposed": transposed,
                     "cin": cin, "cout": cout, "k": k, "stride": stride,
                     "dilation": dil, "t_in": xs[-1], "t_out": t_out, "form": form,
                     "bound_ms": max(flop_ms, moved / HBM_BYTES_PER_S * 1e3),
                     "ncl": _layout_row(lambda: plain(x, w), runs),
                     "cl": _layout_row(cl, runs), "err_ulps": err})
        del x, w, xl, wl
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_stages: needs an NVIDIA card")

    import vrvq_tpu_torch as port
    from vrvq_tpu_torch.infer import fast

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    model = port.build_model(port.FLAGSHIP, device="cuda", seed=0)
    sr = model.sample_rate
    audio = model.preprocess(torch.from_numpy(np.concatenate(
        [port.synthetic_clip(CLIP_S, sr, 10 + i) for i in range(BATCH)])).cuda())
    result = {"nvidia_smi": smi, "card": torch.cuda.get_device_name(0),
              "batch": BATCH, "clip_s": CLIP_S, "runs": RUNS,
              "encoder": {}, "decoder": {}, "memory_gib": {"encoder": {}, "decoder": {}}}
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for name, kw in (("unpacked", {}), ("encode_packed", dict(encode_packed=True))):
            before = torch.cuda.memory_allocated()
            enc = fast.make_serving_model(model, **kw).encoder
            result["encoder"][name] = profile_stack(
                enc, lambda: enc(audio), torch.float32)
            result["memory_gib"]["encoder"][name] = memory_gib(before)
            z = enc(audio)
            del enc
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).split(".")[-1]
            result["decoder"][key] = {}
            result["memory_gib"]["decoder"][key] = {}
            for name, kw in DECODER_VARIANTS.items():
                before = torch.cuda.memory_allocated()
                dec = fast.make_inference_model(
                    model, decode_dtype=None if dtype == torch.float32 else dtype,
                    **kw).decoder
                result["decoder"][key][name] = profile_stack(
                    dec, lambda: dec(z), dtype)
                result["memory_gib"]["decoder"][key][name] = memory_gib(before)
                del dec
                torch.cuda.empty_cache()
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
