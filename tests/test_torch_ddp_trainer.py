"""ZeRO-sharded AdamW and the trainer over two ranks of a gloo process group
on the CPU (each rank a process of its own, ``parallel.spawn``).

The small configuration of ``tests/test_torch_dist_support.py`` from seeded
parameters. ZeRO against replicated AdamW over two ranks: the parameters bit
for bit after 2 steps, and rank 0's consolidated optimizer state the
replicated one's, bit for bit (a checkpoint does not depend on the world
size). Two ranks of ``trainer.train`` (the counterpart of
``tests/test_multihost.py``) end bit-identical, only rank 0 writes, and the
checkpoint they saved resumes in one process.
"""

import numpy as np
import torch

import vrvq_tpu_torch as port
from vrvq_tpu_torch.parallel import dist as pdist
from vrvq_tpu_torch.train import checkpoint as ckpt
from vrvq_tpu_torch.train import trainer
from tests import test_torch_dist_support as support
from tests.test_torch_trainer import _cfg

torch.set_num_threads(1)


def test_zero_matches_replicated_adamw(tmp_path):
    """Two steps of two ranks with AdamW's state sharded against the same
    with it replicated: the parameters bit for bit (each element's update
    is the same arithmetic on the same all-reduced gradient, whichever rank
    owns it), and rank 0's consolidated state dict is the replicated one's,
    bit for bit."""
    case = support.seeded_case(4)
    (tmp_path / "zero").mkdir()
    (tmp_path / "plain").mkdir()
    zero = support.spawn_steps(tmp_path / "zero", case, zero=True, steps=2)
    plain = support.spawn_steps(tmp_path / "plain", case, zero=False, steps=2)
    for z, p in zip(zero, plain):
        support.same_bits(z["params"], p["params"])
        assert z["metrics"] == p["metrics"]
    support.same_bits(zero[0]["opt"], plain[0]["opt"])
    assert zero[1]["opt"] == [None, None]


def test_two_trainer_ranks_are_identical_and_resume_on_one(tmp_path):
    """``trainer.train`` in two ranks for 2 steps (ZeRO on) against the
    JAX package's two-process test (``tests/test_multihost.py``): the same
    parameters bit for bit on both ranks, one log written by rank 0, and the
    checkpoint the two ranks saved resumes for a third step in one process
    on the replicated optimizer."""
    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    for i in range(4):
        port.Signal(port.synthetic_clip(1.0, 44100, 100 + i), 44100).write(
            wav_dir / f"clip_{i}.wav")
    cfg = _cfg(wav_dir, num_iters=2, valid_freq=1, save_iters=[])
    save = tmp_path / "run"
    pdist.spawn(support.train_rank, 2, cfg, str(save), str(tmp_path), True,
                backend="gloo", timeout=support.TIMEOUT_S)
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    support.same_bits(ranks[0]["params"], ranks[1]["params"])
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert ranks[0]["log_file"] == str(save / "log.txt") and ranks[1]["log_file"] is None
    log = (save / "log.txt").read_text()
    assert log.count("[val mean]") == 2 and log.count("Saving to") == 2
    saved = torch.load(save / "latest" / ckpt.STATE_FILE, weights_only=True)
    assert saved["step"] == 2
    for key, value in ranks[0]["params"].items():
        net, name = key.split(".", 1)
        support.same_bits(saved[net][name], value, key)

    resumed = trainer.train({**cfg, "num_iters": 3, "resume": True}, str(save),
                            device="cpu")
    assert resumed.train_state.step == 3 and len(resumed.metrics) == 1
    assert all(np.isfinite(v) for v in resumed.metrics[0].values())
    assert resumed.train_state.opt_g.count == 3
