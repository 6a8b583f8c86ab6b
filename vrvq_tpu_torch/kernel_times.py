"""Device time of the port's two kernels, with a cold L2, at the serve path's shapes.

``python -m vrvq_tpu_torch.kernel_times [--baseline DIR] [--out PATH]``:

  * builds the flagship codec (random seeded weights) and runs the serve
    phase's round trip once (10 s clip, VBR at level 1, 1 s padding-free
    windows, fused quantizer) to take the census of the Snake kernel's shapes
    (shape -> launches);
  * times K2 (Snake) at every census shape, summed over one clip with each
    shape weighted by its launches, and at the one-shot shapes; K1 (fused
    RVQ) at 72 frames (one 1 s window), 576 (eight windows of a
    ``StreamPool`` batch) and 862 (the 10 s clip in one shot); each beside
    its bound and its plain version's time;
  * with ``--baseline DIR``, also loads the ``vrvq_tpu_torch`` package of
    another checkout in DIR (say the parent commit, unpacked there with
    ``git archive``) under another name, builds its kernels, and times the
    two in turns on the same inputs: baseline, current, current, baseline.

Timing (``device_ms``): a CUDA graph of launches, each after a copy of the L2
cache's size that evicts what the last one left there, replayed between CUDA
events, less the same graph of copies alone. The graph runs with no host
between launches, so the host's pace does not count, and every launch reads
from device memory, as the bound assumes. Prints one JSON line and writes it
to ``--out``. Needs an NVIDIA card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import importlib
import importlib.util
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOP_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
SNAKE_ONE_SHOT = [(1, 96, 441344), (1, 1536, 862)]  # decoder tail, head
RVQ_FRAMES = (72, 576, 862)  # one 1 s window; a pool batch of 8; 10 s at once
CLIP_S = 10.0
WINDOW_S = 1.0
CALLS = 40  # launches in one timed graph
REPEATS = 9  # replays of each graph; the median is kept
TIE_MARGIN = 1e-5  # top-2 score margin at or under which a code may flip
DEVICE = "cuda"


def bound(n_bytes: float, n_flops: float) -> dict:
    """Least time on an H100 SXM at its data-sheet rates: the larger of the
    bytes over the memory rate and the f32 operations over the f32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "flops_ms": t_ops}


def snake_bound(shape, itemsize: int = 4) -> dict:
    """x read, alpha (float32) read, y written, ``itemsize`` bytes an
    element; ~5 operations and a sin (or its polynomial) per element."""
    n = math.prod(shape)
    return bound(itemsize * 2.0 * n + 4.0 * shape[1], 5.0 * n)


def snake_backward_bound(shape, approx: bool = False) -> dict:
    """x and g read, dx written (12 bytes an element), alpha read and dalpha
    written; ~20 operations, a sin and a cos per element (the polynomial
    mode: 44, its reduction and two Horner chains)."""
    n = math.prod(shape)
    return bound(12.0 * n + 8.0 * shape[1], (44.0 if approx else 20.0) * n)


def rvq_bound(frames: int, n_q: int, d_model: int, d_code: int, k: int) -> dict:
    """The weights (wi, bi, wo, bo, codebook), z and the mask read once, z_q
    and the codes written once; the three products of every stage."""
    w_bytes = 4 * n_q * (2 * d_model * d_code + d_code + d_model + k * d_code)
    io_bytes = 4 * frames * (2 * d_model + 2 * n_q)
    flops = frames * n_q * (2 * d_model * d_code + 2 * k * d_code
                            + 2 * d_code * d_model)
    return bound(w_bytes + io_bytes, flops)


@contextlib.contextmanager
def snake_census(*models, by_mode: bool = False):
    """While open, counts the input shapes of every ``Snake1d`` call in
    ``models``, or with no models in whichever model runs (a CLI that builds
    its own): yields a Counter of shape -> calls, or with ``by_mode`` of
    (mode, shape) -> calls, the mode named as ``ops.snake.mode_name`` (its
    layout read from the input's strides)."""
    from .nn.layers import Snake1d
    from .ops.snake import is_channels_last, mode_name

    census = collections.Counter()

    def count(module, args):
        if not isinstance(module, Snake1d):
            return
        shape = tuple(args[0].shape)
        if by_mode:
            x = args[0]
            census[mode_name(x.dtype, module.approx, is_channels_last(x)), shape] += 1
        else:
            census[shape] += 1

    if models:
        hooks = [m.register_forward_pre_hook(count)
                 for model in models for m in model.modules()
                 if isinstance(m, Snake1d)]
    else:
        hooks = [torch.nn.modules.module.register_module_forward_pre_hook(count)]
    try:
        yield census
    finally:
        for h in hooks:
            h.remove()


def device_ms(fn, args=()) -> float:
    """Device time of one ``fn(*args)`` with a cold L2, in ms.

    Two CUDA graphs: ``CALLS`` times a copy of the L2 cache's size (twice its
    size of distinct lines touched) followed by ``fn``, and the copies alone.
    Each is replayed ``REPEATS`` times in turns between CUDA events; the
    difference of the median replays over ``CALLS`` is ``fn``'s time. The
    copy evicts what the last call left in L2, so every call reads its inputs
    from device memory, and the write-back of its outputs falls in the
    difference. ``fn`` runs once before the capture (build, allocations)."""
    l2 = torch.cuda.get_device_properties(torch.cuda.current_device()).L2_cache_size
    src = torch.empty(l2 // 4, device=DEVICE)
    dst = torch.empty_like(src)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # torch's warm-up before a capture
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for with_fn in (False, True):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(CALLS):
                dst.copy_(src)
                if with_fn:
                    fn(*args)
        graph.replay()
        graphs.append(graph)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    replays = ([], [])
    for _ in range(REPEATS):
        for graph, ms in zip(graphs, replays):
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
    return (statistics.median(replays[1]) - statistics.median(replays[0])) / CALLS


def snake_inputs(shape, gen, dtype=torch.float32, channels_last: bool = False):
    """x (3 N(0, 1), in ``dtype``; in channels-last memory with
    ``channels_last``) and alpha (0.5 + U(0, 1), float32) on the card, from
    ``gen``."""
    from .nn.layers import to_channels_last

    x = (3.0 * torch.randn(shape, generator=gen)).to(DEVICE, dtype)
    alpha = (0.5 + torch.rand(shape[1], generator=gen)).to(DEVICE)
    return (to_channels_last(x) if channels_last else x), alpha


def snake_fns(snake_mod, approx: bool = False):
    """(kernel, plain) of a mode of ``snake_mod`` (an ``ops.snake`` module),
    each taking (x, alpha); the exact mode by the names every version of
    the module has."""
    if not approx:
        return snake_mod.snake, snake_mod.snake_reference
    return ((lambda x, a: snake_mod.snake(x, a, True)),
            snake_mod.snake_approx_reference)


def time_snake(snake_mod, x, alpha, plain: bool = True,
               approx: bool = False, timed: bool = True) -> dict:
    """K2 of ``snake_mod`` (an ``ops.snake`` module) on ``x``, ``alpha`` in
    the mode of ``approx`` and ``x``'s dtype: its largest difference from
    the plain version on these inputs, its device time (with ``timed``),
    the plain version's when ``plain``, and the bound."""
    kernel, reference = snake_fns(snake_mod, approx)
    err = (kernel(x, alpha).float()
           - reference(x, alpha).float()).abs().max().item()
    out = {"shape": list(x.shape), "max_abs_err": err,
           **snake_bound(x.shape, x.element_size())}
    if timed:
        out["ms"] = device_ms(kernel, (x, alpha))
        if plain:
            out["plain_ms"] = device_ms(reference, (x, alpha))
    return out


def time_snake_backward(snake_mod, x, alpha, g, approx: bool = False) -> dict:
    """K2's backward kernel of ``snake_mod`` in the float32 mode of
    ``approx`` on ``x``, ``alpha`` and the output gradient ``g``: dx's
    largest difference from the plain version over max|dx|
    (``dx_rel_err``), dalpha's over max|dalpha| (``dalpha_rel_err``),
    whether two launches give the same bits, the device time, the plain
    version's and the bound."""
    kernel, reference = snake_mod.snake_backward, snake_mod.snake_backward_reference
    if approx:
        kernel = functools.partial(snake_mod.snake_backward, approx=True)
        reference = snake_mod.snake_approx_backward_reference
    dx, da = kernel(x, alpha, g)
    dx2, da2 = kernel(x, alpha, g)
    rdx, rda = reference(x, alpha, g)
    out = {"shape": list(x.shape),
           "dx_rel_err": ((dx - rdx).abs().max() / rdx.abs().max()).item(),
           "dalpha_rel_err": ((da - rda).abs().max() / rda.abs().max()).item(),
           "bit_identical": bool(torch.equal(dx, dx2) and torch.equal(da, da2)),
           **snake_backward_bound(x.shape, approx)}
    out["max_abs_err"] = max(out["dx_rel_err"], out["dalpha_rel_err"])
    out["ms"] = device_ms(kernel, (x, alpha, g))
    out["plain_ms"] = device_ms(reference, (x, alpha, g))
    return out


def rvq_inputs(frames: int, n_q: int, d_model: int, gen):
    """z (F, D) N(0, 1) and a VBR mask (F, Nq) of about half ones, on the card."""
    z = torch.randn(frames, d_model, generator=gen).to(DEVICE)
    mask = (torch.rand(frames, n_q, generator=gen) > 0.5).float().to(DEVICE)
    return z, mask


def rvq_compare(rvq_mod, z, weights, prepared, mask) -> dict:
    """K1 of ``rvq_mod`` against its plain version on the same inputs: the
    frames whose codes differ, those of them that are no near tie (top-2
    margin of the plain version over ``TIE_MARGIN``), and the largest z_q
    difference on the frames whose codes agree."""
    zq, codes = rvq_mod.fused_rvq_prepared(z, prepared, mask)
    rzq, rcodes = rvq_mod.fused_rvq_reference(z, *weights, mask)
    near_tie = rvq_mod.reference_margins(z, *weights) <= TIE_MARGIN
    agree = (codes == rcodes).all(dim=1)
    return {"near_tie_frames": int(near_tie.sum()),
            "flipped_frames": int((~agree).sum()),
            "flipped_off_tie": int((~agree & ~near_tie).sum()),
            "max_abs_err": (zq - rzq)[agree].abs().max().item()}


def time_rvq(rvq_mod, weights, z, mask, plain: bool = True) -> dict:
    """K1 of ``rvq_mod`` (an ``ops.rvq_kernel`` module) on ``weights`` (wi,
    bi, wo, bo, cb), prepared once as the main path prepares them once per
    ``compress``, and on ``z``, ``mask``: ``rvq_compare`` on these inputs,
    the device time, the plain version's when ``plain``, and the bound."""
    weights = rvq_mod.RVQWeights(*weights)
    n_q, d_model, d_code = weights.wi.shape
    prepared = rvq_mod.prepare_rvq(weights)
    out = {"frames": z.shape[0], "n_q": n_q,
           **rvq_compare(rvq_mod, z, weights, prepared, mask),
           "ms": device_ms(rvq_mod.fused_rvq_prepared, (z, prepared, mask)),
           **rvq_bound(z.shape[0], n_q, d_model, d_code, weights.cb.shape[1])}
    if plain:
        out["plain_ms"] = device_ms(rvq_mod.fused_rvq_reference,
                                    (z, *weights, mask))
    return out


def load_package(root: Path, name: str = "vrvq_baseline"):
    """The ``vrvq_tpu_torch`` package under ``root``, imported as ``name``
    (its relative imports resolve inside it, its kernels build under it)."""
    init = Path(root).resolve() / "vrvq_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def serve_census(port, model) -> collections.Counter:
    """Snake shapes -> launches of one serve round trip: the 10 s clip
    compressed (VBR, level 1, 1 s windows, fused quantizer), decompressed."""
    proc = port.CodecProcessor(model, fused_quantizer=True)
    signal = port.Signal(port.synthetic_clip(CLIP_S, model.sample_rate, 0),
                         model.sample_rate)
    with snake_census(proc.model_nopad) as census:
        proc.decompress(proc.compress(signal, win_duration=WINDOW_S, level=1.0))
    return census


def census_sum(rows, census, key: str) -> float:
    """Sum over the census of launches x ``row[key]`` (rows keyed by shape)."""
    return sum(census[tuple(r["shape"])] * r[key] for r in rows)


def time_package(pkg, census, weights, plain: bool) -> dict:
    """Every timing of one package's kernels, on inputs drawn from the same
    seed for every package."""
    snake_mod = importlib.import_module(f"{pkg.__name__}.ops.snake")
    rvq_mod = importlib.import_module(f"{pkg.__name__}.ops.rvq_kernel")
    gen = torch.Generator().manual_seed(0)
    n_q, d_model, _ = weights[0].shape
    with torch.inference_mode():
        rows = [time_snake(snake_mod, *snake_inputs(s, gen), plain)
                for s in sorted(census)]
        one_shot = [time_snake(snake_mod, *snake_inputs(s, gen), plain)
                    for s in SNAKE_ONE_SHOT]
        rvq = [time_rvq(rvq_mod, weights, *rvq_inputs(f, n_q, d_model, gen),
                        plain) for f in RVQ_FRAMES]
    out = {"package": pkg.__name__,
           "snake_census_ms": census_sum(rows, census, "ms"),
           "snake_max_abs_err": max(r["max_abs_err"] for r in rows + one_shot),
           "snake_shapes": rows, "snake_one_shot": one_shot, "rvq": rvq}
    if plain:
        out["snake_census_plain_ms"] = census_sum(rows, census, "plain_ms")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", default=None,
                    help="root of another checkout whose kernels to time in "
                         "turns with this one's")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: needs an NVIDIA card")

    import vrvq_tpu_torch as port
    from vrvq_tpu_torch.ops.rvq_kernel import stack_quantizer_weights

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    model = port.build_model(port.FLAGSHIP, device=DEVICE, seed=0)
    census = serve_census(port, model)
    with torch.inference_mode():
        weights = tuple(stack_quantizer_weights(model.quantizer))

    turns = [port]
    if args.baseline:
        base = load_package(Path(args.baseline))
        turns = [base, port, port, base]
    # the plain versions timed in the first of this package's turns
    runs = [time_package(pkg, census, weights,
                         plain=pkg is port and port not in turns[:i])
            for i, pkg in enumerate(turns)]
    result = {
        "nvidia_smi": smi, "card": torch.cuda.get_device_name(0),
        "l2_bytes": torch.cuda.get_device_properties(0).L2_cache_size,
        "census_launches": sum(census.values()), "census_shapes": len(census),
        "census": [[list(s), n] for s, n in sorted(census.items())],
        "snake_census_bound_ms": sum(n * snake_bound(s)["bound_ms"]
                                     for s, n in census.items()),
        "runs": runs,
    }
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
