"""Export a generator to the reference's torch layout, the counterpart of
``scripts/export_torch.py``::

    python -m vrvq_tpu_torch.cli.export_torch --args.load conf/vrvq/vrvq_a2.yml \
        --ckpt_dir ckpt --tag latest --out weights.pth

The generator comes from ``--torch_ckpt``, ``--ckpt_dir``/``--ckpt_path`` at
``--tag`` (the port's own checkpoints) or a seeded draw, as the inference CLI
takes it (``train/checkpoint.load_gen_params``), and is written as
``{"state_dict": ...}`` in the reference's layout
(``train/checkpoint.save_torch_checkpoint``): a file that the reference's
``load_state_dict``, the JAX package's ``load_torch_checkpoint`` and this
package's ``--torch_ckpt`` all read. Loads on the card unless ``--device
cpu`` is given.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from .. import disable_tf32
from ..config import REPO, model_config, parse_args
from ..models.dac_vrvq import DAC_VRVQ
from ..train.checkpoint import load_gen_params, save_torch_checkpoint


def main(argv: Optional[List[str]] = None) -> str:
    cfg = parse_args(argv, base_dir=REPO)
    disable_tf32()
    model = load_gen_params(cfg, DAC_VRVQ(model_config(cfg)), cfg.get("device", "cuda"))
    out = cfg.get("out", "weights.pth")
    save_torch_checkpoint(model, out)
    print(f"wrote {out}", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
