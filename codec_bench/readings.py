"""Readings that set a cell's limits: the compared numbers of the program on
many seeds, and of the control and the planted faults on a few, in one
process.

    python3 -m codec_bench.readings --workload <name> --seeds 1,2,3 \
        --impl program|control|half_batch [--fault NAME] [--seconds S] \
        [--param key=value ...]

``--impl program`` runs the cell as ``run.py`` does, at a short window
(``--seconds``); ``control`` puts the reference at the next lower precision
in the program's place; ``half_batch`` (training) the reference on the
first half of each batch. ``--fault`` plants one of a driver's faults in
the program. One JSON line a seed: the numbers, their limits, ``correct``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import harness
from .run import build_run, cache_dirs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--impl", default="program")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--param", action="append", default=[])
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    for seed in args.seeds.split(","):
        run = build_run(args.workload, int(seed), args.seconds, False,
                        args.param + [f'impl="{args.impl}"'], fault=args.fault)
        t0 = time.perf_counter()
        harness.driver(run.mix["driver"]).drive(run)
        print(json.dumps({
            "workload": args.workload, "seed": int(seed), "impl": args.impl,
            "fault": args.fault, "correct": run.correct, "e2e": run.e2e,
            "seconds": time.perf_counter() - t0,
            "counters": run.counters,
            "checks": {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()},
            "card": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
        }), flush=True)
        del run
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
