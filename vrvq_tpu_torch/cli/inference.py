"""VBR inference CLI, the counterpart of ``scripts/inference.py``: a level
sweep over examples of a folder of audio::

    python -m vrvq_tpu_torch.cli.inference --args.load conf/vrvq/vrvq_a2.yml \
        --ckpt_dir ckpt --tag latest --data_dir wavs --save_result_dir results

The generator comes from ``--torch_ckpt`` (a reference-layout state dict),
``--ckpt_dir``/``--ckpt_path`` at ``--tag`` (the port's own checkpoints), or
a seeded draw (``train/checkpoint.py: load_gen_params``). As in the JAX CLI,
``--fast`` (on by default) serves the fast profile (weight norm folded out of
the decoder, which runs in bfloat16 with the polynomial Snake; the codes are
the live encoder's); ``DAC_VRVQ.compute_dtype: bfloat16`` serves both conv
stacks in bfloat16 (``infer/fast.serving_model``). For each of ``--num_examples`` (30) excerpts of
``--duration`` s (10) it writes ``LevelSweep.save_results``'s folder:
``recon_<level>.wav`` at each of ``--levels``, ``input.wav``,
``metadata.json`` and the mask PNGs. Runs on the card unless ``--device
cpu`` is given. The sweep is VBR's: a CBR model raises.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import numpy as np
import torch

from .. import disable_tf32, resolve_device
from ..config import REPO, model_config, parse_args
from ..data.loaders import AudioLoader
from ..infer.fast import serving_model
from ..infer.sweep import DEFAULT_LEVELS, save_results
from ..models.dac_vrvq import DAC_VRVQ
from ..train.checkpoint import load_gen_params


def main(argv: Optional[List[str]] = None) -> int:
    cfg = parse_args(argv, base_dir=REPO)
    device = resolve_device(cfg.get("device", "cuda"))
    disable_tf32()
    model = DAC_VRVQ(model_config(cfg))
    if not model.vbr:
        raise ValueError("the level sweep needs a VBR model; this config is CBR")
    model = serving_model(load_gen_params(cfg, model, device).eval(),
                          fast=cfg.get("fast", True))

    loader = AudioLoader(sources=[cfg.get("data_dir")], shuffle=False)
    levels = cfg.get("levels", DEFAULT_LEVELS)
    out_dir = cfg.get("save_result_dir", "results")
    n = min(cfg.get("num_examples", 30), len(loader.audio_indices))
    for idx in range(n):
        item = loader(state=np.random.RandomState(idx),
                      sample_rate=model.sample_rate,
                      duration=cfg.get("duration", 10), num_channels=1)
        audio = torch.from_numpy(
            np.asarray(item["signal"].audio_data, np.float32)).to(device)
        save_results(model, audio, levels, out_dir)
        print("Saved results for", idx, flush=True)
    return n


if __name__ == "__main__":
    main(sys.argv[1:])
