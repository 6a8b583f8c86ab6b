"""Run one cell of the benchmark once.

    python3 -m codec_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints one JSON line last on standard output
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit), and the compared numbers as the last lines of standard
error. Exits 1, printing no result, when CUDA or the cell's cards are
missing, or when a module of JAX or of the JAX package was loaded.
``--param key=value`` (repeatable) overrides a number of the cell's
traffic mix, for sweeps; the benchmark's own runs never pass it.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()  # set-up counts from here: imports are loading

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import harness  # noqa: E402


def build_run(workload: str, seed: int, seconds: float, trace: bool,
              params=(), device: str = "cuda", fault=None) -> harness.Run:
    bench = harness.spec()
    w = harness.cell(workload, bench)
    mix = harness.read_json("traffic", w["traffic"])
    for item in params:
        key, value = item.split("=", 1)
        mix[key] = json.loads(value)
    return harness.Run(
        workload=workload, seed=int(seed), seconds=float(seconds), trace=bool(trace),
        config=harness.read_json("configs", w["config"]), mix=mix,
        limits=harness.read_json("checks", workload), chips=int(w["chips"]),
        device=device, fault=fault)


def cache_dirs() -> None:
    """Every cache the program or PyTorch may write, inside the checkout at
    fixed paths (the kernels' library already builds into the program's
    own ``kernels/_build``)."""
    root = harness.REPO / ".bench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(root / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(root / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(root / "nv"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--param", action="append", default=[])
    args = ap.parse_args(argv)
    cache_dirs()
    run = build_run(args.workload, args.seed, args.seconds, bool(args.trace), args.param)
    run.started = STARTED

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < run.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"needs {run.chips} CUDA card(s), found {found}", file=sys.stderr)
        return 1
    harness.driver(run.mix["driver"]).drive(run)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 1
    out = harness.result(run, harness.spec())
    print(json.dumps(out), flush=True)
    print("counters " + json.dumps(run.counters), file=sys.stderr)
    for name, (value, limit) in run.checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
