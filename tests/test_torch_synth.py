"""The port's synthetic-corpus generator (``vrvq_tpu_torch/data/synth.py``,
``cli/make_synth_dataset.py``) against the JAX package's
``scripts/make_synth_dataset.py``, loaded by path as
``tests/test_synth_dataset.py`` loads it.

Tolerance: none. Every class, and the mixed draw, gives the JAX script's
clip bit for bit from the same generator state, and the CLI writes the
script's file names with its bytes and prints its lines, for the harmonic
corpus and for ``--classes all --seed 7``; an unknown class fails with the
script's error.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vrvq_tpu_torch.cli import make_synth_dataset as cli_synth
from vrvq_tpu_torch.data import synth

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "make_synth_dataset.py"

_spec = importlib.util.spec_from_file_location("_jax_make_synth_dataset", SCRIPT)
jsynth = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jsynth)

# small corpora: three splits of a few quarter-second clips
SMALL = ["--train", "3", "--val", "2", "--test", "2", "--duration", "0.25"]


def test_the_same_classes_in_the_same_order():
    assert list(synth.CLIP_CLASSES) == list(jsynth.CLIP_CLASSES)


@pytest.mark.parametrize("seed,dur", [(0, 0.25), (5, 0.5), (123, 0.1)])
@pytest.mark.parametrize("name", sorted(jsynth.CLIP_CLASSES))
def test_each_class_is_jaxs_clip_bit_for_bit(name, seed, dur):
    got = synth.synth_clip(np.random.RandomState(seed), 44100, dur, classes=(name,))
    want = jsynth.synth_clip(np.random.RandomState(seed), 44100, dur, classes=(name,))
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", [0, 7, 9, 31, 2024])
def test_the_mixed_draw_is_jaxs_bit_for_bit(seed):
    """Every class allowed: the class picks (a mix a quarter of the time),
    the clip and what the generator has left all equal JAX's."""
    classes = tuple(jsynth.CLIP_CLASSES)
    rng_t, rng_j = np.random.RandomState(seed), np.random.RandomState(seed)
    got, picks = synth.synth_clip_with_classes(rng_t, 44100, 0.3, classes)
    want, jpicks = jsynth.synth_clip_with_classes(rng_j, 44100, 0.3, classes)
    assert picks == jpicks
    assert got.tobytes() == want.tobytes()
    assert rng_t.randint(2 ** 31) == rng_j.randint(2 ** 31)


def test_one_class_draws_no_class_pick():
    """A single-class corpus takes no class-pick draw: a generator that
    made the harmonic clip is where JAX's is, not one draw further."""
    rng_t, rng_j = np.random.RandomState(3), np.random.RandomState(3)
    synth.synth_clip(rng_t, 44100, 0.2)
    jsynth.synth_clip(rng_j, 44100, 0.2)
    assert rng_t.get_state()[2] == rng_j.get_state()[2]
    assert np.array_equal(rng_t.get_state()[1], rng_j.get_state()[1])


def _run(cmd, out: Path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    # the printed lines name the output folder: compare them without it
    return proc.returncode, proc.stdout.replace(str(out), "<out>"), proc.stderr


def _corpus(root: Path):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*.wav"))}


@pytest.mark.parametrize("flags", [[], ["--classes", "all", "--seed", "7"]],
                         ids=["harmonic", "all-seed7"])
def test_cli_writes_jaxs_corpus(tmp_path, capsys, flags):
    """The port's ``main`` in this process (``python -m`` runs it in
    ``test_unknown_class_fails_as_jax_does``) against the JAX script."""
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    cli_synth.main(["--out", str(ours), *SMALL, *flags])
    out_t = capsys.readouterr().out.replace(str(ours), "<out>")
    rc_j, out_j, err_j = _run([sys.executable, str(SCRIPT), "--out", str(theirs),
                               *SMALL, *flags], theirs)
    assert rc_j == 0, err_j[-2000:]
    assert out_t == out_j
    assert out_t.splitlines() == [f"{s}: {n} x 0.25s -> <out>/{s}"
                                  for s, n in (("train", 3), ("val", 2), ("test", 2))]
    got, want = _corpus(ours), _corpus(theirs)
    assert list(got) == list(want) and len(got) == 7
    if flags:  # a corpus of several classes tags each file with its picks
        assert all(name.count("_") == 2 for name in got), list(got)
    else:
        assert "train/train_0000.wav" in got
    for name in got:
        assert got[name] == want[name], name


def test_main_writes_jaxs_clips_as_16_bit_pcm(tmp_path, capsys):
    """``main(argv)`` in this process: each file is the 16-bit PCM of JAX's
    clip for its seed."""
    cli_synth.main(["--out", str(tmp_path), "--train", "1", "--val", "1",
                    "--test", "1", "--duration", "0.1", "--seed", "4"])
    from vrvq_tpu_torch.data.audio_io import read_wav

    for si, split in enumerate(cli_synth.SPLITS):
        data, sr = read_wav(tmp_path / split / f"{split}_0000.wav")
        want = jsynth.synth_clip(
            np.random.RandomState((4 * 1_000_003 + si * 99991) % 2 ** 32), 44100, 0.1)
        assert sr == 44100
        pcm = np.round(np.clip(want, -1, 1) * 32767.0).astype(np.int16)
        assert np.array_equal(np.round(data[0] * 32768.0).astype(np.int16), pcm)
    assert capsys.readouterr().out.count("x 0.1s ->") == 3


def test_unknown_class_fails_as_jax_does(tmp_path):
    rc_t, _, err_t = _run([sys.executable, "-m", "vrvq_tpu_torch.cli.make_synth_dataset",
                           "--out", str(tmp_path / "a"), "--classes", "harmonic,bogus"],
                          tmp_path)
    rc_j, _, err_j = _run([sys.executable, str(SCRIPT), "--out", str(tmp_path / "b"),
                           "--classes", "harmonic,bogus"], tmp_path)
    assert rc_t == rc_j == 2
    assert err_t.strip().splitlines()[-1] == err_j.strip().splitlines()[-1] == (
        "make_synth_dataset.py: error: unknown class 'bogus'")
    assert not (tmp_path / "a").exists() and not (tmp_path / "b").exists()
