"""The flagship's reference codes and audio, computed on the CPU, for the
card to be held against.

The port's flagship ``DAC_VRVQ``, drawn on the CPU from ``SEED`` by
``convert.init_params`` (on the CPU it gives the JAX package's codes bit for
bit, ``tests/test_torch_model.py``), compresses a seeded 3 s clip in VBR at
level 1 in 1 s windows and decompresses it. ``fixtures/flagship_seed0_3s.npz``
keeps the codes and counts of the whole clip and the first second of the
decoded audio (float32, under 200 KB); ``tests/test_torch_reference.py``
checks that the CPU still computes it, and ``chip_smoke.py``'s reference
phase holds the card's codes and decode against it.

``python -m vrvq_tpu_torch.reference [--out PATH]`` writes it anew (on the
CPU, in about ten seconds).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "flagship_seed0_3s.npz"
SEED = 0  # the model's, as chip_smoke.py draws it
CLIP_SEED = 1  # the clip's (chip_smoke.py's agree clip)
CLIP_S = 3.0
WINDOW_S = 1.0
LEVEL = 1.0
AUDIO_S = 1.0  # decoded audio kept


def clip(sample_rate: int) -> np.ndarray:
    from .audio import synthetic_clip

    return synthetic_clip(CLIP_S, sample_rate, CLIP_SEED)


def compute(model, fused_quantizer: bool = True) -> dict:
    """Codes, counts and the first ``AUDIO_S`` of decoded audio of the
    reference clip through ``model``'s ``CodecProcessor``, and the file."""
    from .audio import Signal
    from .infer.codec_api import CodecProcessor

    sr = model.sample_rate
    proc = CodecProcessor(model, fused_quantizer=fused_quantizer)
    dac = proc.compress(Signal(clip(sr), sr), win_duration=WINDOW_S, level=LEVEL)
    audio = proc.decompress(dac).audio_data
    return {"codes": dac.codes, "counts": dac.vbr_counts,
            "audio": np.asarray(audio[0, 0, : int(AUDIO_S * sr)], np.float32),
            "dac": dac}


def load() -> dict:
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(FIXTURE))
    args = ap.parse_args()
    from . import FLAGSHIP, build_model

    model = build_model(FLAGSHIP, device="cpu", seed=SEED)
    out = compute(model)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        args.out, codes=out["codes"].astype(np.int16),
        counts=out["counts"].astype(np.uint8), audio=out["audio"],
        chunk_length=np.int32(out["dac"].chunk_length),
        input_db=np.float32(out["dac"].input_db))
    print(args.out, Path(args.out).stat().st_size, "bytes")


if __name__ == "__main__":
    main()
