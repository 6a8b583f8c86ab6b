"""Write a synthetic corpus of 16-bit wavs (``data/synth.py``), the
counterpart of ``scripts/make_synth_dataset.py``, with its flags, seeds,
file names and bytes::

    python -m vrvq_tpu_torch.cli.make_synth_dataset --out data_synth
    python -m vrvq_tpu_torch.cli.make_synth_dataset --out data_synth_rich \
        --classes all --seed 7 --train 384

The first is the harmonic corpus of ``conf/vrvq/vrvq_a2_synth_demo.yml``
and ``_20k.yml``, the second the mixed corpus of
``conf/vrvq/vrvq_a2_synth_rich_30k.yml``. Each of the splits ``train``,
``val`` and ``test`` gets ``{split}_{i:04d}.wav`` (tagged
``_<class>[+<class>]`` in a corpus of more than one class); clip ``i`` of
split ``si`` is drawn from ``RandomState((seed * 1_000_003 + si * 99991 +
i) % 2**32)``. Needs numpy only.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..data.audio_io import write_wav
from ..data.synth import CLIP_CLASSES, synth_clip_with_classes

SPLITS = ("train", "val", "test")


def clip_seed(seed: int, split_index: int, i: int) -> int:
    """The generator seed of clip ``i`` of the ``split_index``-th split."""
    return (seed * 1_000_003 + split_index * 99991 + i) % 2**32


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="data")
    ap.add_argument("--train", type=int, default=256)
    ap.add_argument("--val", type=int, default=16)
    ap.add_argument("--test", type=int, default=8)
    ap.add_argument("--sample_rate", type=int, default=44100)
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--classes", default="harmonic",
                    help="comma list from %s, or 'all' (the default is the "
                         "harmonic corpus)" % ",".join(CLIP_CLASSES))
    args = ap.parse_args(argv)
    classes = (tuple(CLIP_CLASSES) if args.classes == "all"
               else tuple(args.classes.split(",")))
    for c in classes:
        if c not in CLIP_CLASSES:
            ap.error(f"unknown class {c!r}")

    counts = (args.train, args.val, args.test)
    for si, (split, count) in enumerate(zip(SPLITS, counts)):
        out = Path(args.out) / split
        out.mkdir(parents=True, exist_ok=True)
        for i in range(count):
            rng = np.random.RandomState(clip_seed(args.seed, si, i))
            clip, picks = synth_clip_with_classes(
                rng, args.sample_rate, args.duration, classes=classes)
            # a corpus of several classes tags each file with its picks, so
            # evaluation can group by class
            tag = "" if len(classes) == 1 else "_" + "+".join(picks)
            write_wav(out / f"{split}_{i:04d}{tag}.wav", clip[None, :],
                      args.sample_rate)
        print(f"{split}: {count} x {args.duration}s -> {out}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
