"""``vrvq_tpu_torch/cli/measure_trained.py`` (the counterpart of
``scripts/measure_r4.py``) on the CPU, and the gate's probe corpus against
the JAX package's.

A small model on top of ``conf/vrvq/vrvq_a2_synth_demo.yml``
(``tests/tiny_synth_demo.yml``), trained by the port's train CLI for 2
steps at batch 2 x 0.1 s on a corpus that ``cli.make_synth_dataset`` writes
(8 test clips of 0.3 s, the gates' probe), measured at 1 x 0.25 s.

Checked: a checkpoint under 1000 steps is refused, by the CLI too, which
takes JAX's positional arguments and ``--device`` and no flag that lowers
the floor (at 1000 steps it loads); the printed lines carry the JAX script's keys in its order (its own output,
``MEASURE_r5_rich.jsonl``, is the reference: this file cannot run the JAX
script, which builds the flagship); the gate lines equal ``fast.turbo_gate``
of the same model and probe exactly (the CPU repeats its bits), and name
the held-out corpus of 8 clips, not the fallback; ``bench_audio`` equals
``bench._bench_audio`` bit for bit; ``fast._probe_corpus`` reads what the
JAX package's reads (the first 8 wavs in sorted order, the first channel,
trimmed to the shortest; ``None`` for a missing or empty folder or a rate
off the model's).
"""

import importlib.util
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from vrvq_tpu.infer import fast as jfast
from vrvq_tpu_torch.cli import make_synth_dataset as cli_synth
from vrvq_tpu_torch.cli import measure_trained as mt
from vrvq_tpu_torch.cli import train as cli_train
from vrvq_tpu_torch.data.audio_io import write_wav
from vrvq_tpu_torch.infer import fast

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
TINY_YML = REPO / "tests" / "tiny_synth_demo.yml"
BATCH, SECONDS = 1, 0.25


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """(root, tiny.yml, checkpoint dir, probe dir): a corpus from the port's
    generator and a checkpoint from its train CLI, 2 steps."""
    root = tmp_path_factory.mktemp("measure")
    corpus = root / "corpus"
    cli_synth.main(["--out", str(corpus), "--train", "4", "--val", "2", "--test", "8",
                    "--duration", "0.3"])
    save = root / "ckpt"
    cli_train.main([
        "--args.load", str(TINY_YML), "--device", "cpu", "--save_path", str(save),
        "--num_iters", "2", "--valid_freq", "1",
        "--train/build_dataset.folders", repr({"music": [str(corpus / "train")]}),
        "--val/build_dataset.folders", repr({"music": [str(corpus / "val")]})])
    assert json.loads((save / "latest" / "meta.json").read_text())["step"] == 2
    return root, TINY_YML, save, corpus / "test"


@pytest.fixture(scope="module")
def printed(trained, tmp_path_factory):
    """``measure``'s printed lines, parsed, and its returned ones, for the
    2-step checkpoint (``min_steps=0``), as ``chip_smoke.py`` measures one."""
    _, conf, save, probe = trained
    import contextlib
    import io

    model = mt.trained_flagship(save, min_steps=0, device="cpu", config=str(conf))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lines = mt.measure(model, BATCH, SECONDS, str(save), str(probe))
    return [json.loads(ln) for ln in buf.getvalue().splitlines()], lines


def jax_lines():
    """The JAX script's lines of one run (its first 12: the ckpt/probe line,
    2 gates, 4 packed decoders, 5 profiles)."""
    text = (REPO / "MEASURE_r5_rich.jsonl").read_text().splitlines()
    return [json.loads(ln) for ln in text[:12]]


def test_under_1000_steps_is_refused(trained):
    _, conf, save, probe = trained
    with pytest.raises(SystemExit) as exc:
        mt.trained_flagship(save, device="cpu", config=str(conf))
    msg = str(exc.value)
    assert f"{save} is at step 2 (< 1000)" in msg
    assert "near-init checkpoint gives meaningless gate verdicts" in msg
    with pytest.raises(SystemExit) as exc:  # the CLI's floor, which no flag lowers
        mt.main(["1", "0.25", str(save), str(probe), "--device", "cpu"])
    assert f"{save} is at step 2 (< 1000)" in str(exc.value)


def test_cli_takes_jaxs_positional_arguments_and_the_device():
    args = mt.parse([])
    assert (args.batch, args.seconds, args.ckpt_dir, args.probe_dir, args.device) == (
        16, 10.0, "ckpt/synth_demo", "data_synth/test", "cuda")
    args = mt.parse(["2", "1.0", "ck", "probe", "--device", "cpu"])
    assert (args.batch, args.seconds, args.ckpt_dir, args.probe_dir, args.device) == (
        2, 1.0, "ck", "probe", "cpu")
    for flag in ("--min_steps", "--args.load"):
        with pytest.raises(SystemExit):
            mt.parse([flag, "0"])


def test_1000_steps_loads_the_generator(trained, tmp_path):
    _, conf, save, _ = trained
    at_1000 = tmp_path / "ckpt"
    shutil.copytree(save, at_1000)
    meta = json.loads((at_1000 / "latest" / "meta.json").read_text())
    (at_1000 / "latest" / "meta.json").write_text(json.dumps({**meta, "step": 1000}))
    model = mt.trained_flagship(at_1000, device="cpu", config=str(conf))
    saved = torch.load(save / "latest" / "state.pt", map_location="cpu",
                       weights_only=True)["generator"]
    assert not model.training
    for k, v in model.state_dict().items():
        assert torch.equal(v, saved[k]), k


def test_lines_carry_jaxs_keys_in_its_order(printed):
    got, returned = printed
    assert got == returned
    want = jax_lines()
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        assert list(g) == list(w), (g, w)
        for name in ("gate", "profile"):
            assert g.get(name) == w.get(name)
    for line in got[7:]:
        assert line["encode_ms"] > 0 and line["forward_ms"] > 0 and line["rtf"] > 0
    for line in got[3:7]:  # the same codes, two decoders: close, or equal
        assert line["agreement_db"] > 30, line


def test_gate_lines_are_turbo_gates_on_the_held_out_corpus(trained, printed):
    _, conf, save, probe = trained
    got, _ = printed
    assert got[0] == {"ckpt_dir": str(save), "probe_dir": str(probe)}
    model = mt.trained_flagship(save, min_steps=0, device="cpu", config=str(conf))
    for line, (name, kw) in zip(got[1:3], mt.GATES):
        want = mt.gate_line(name, fast.turbo_gate(model, probe_dir=str(probe), **kw))
        assert line == json.loads(json.dumps(want)), (line, want)
        assert line["probe"] == f"held-out corpus {probe} (8 clips)"
        assert len(line["clip_agreement_db"]) == 8


def test_bench_audio_is_jaxs():
    spec = importlib.util.spec_from_file_location("_jax_bench", REPO / "bench.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    assert mt.SAMPLE_RATE == bench.SAMPLE_RATE
    for batch, seconds, seed in ((4, 2.0, 7), (2, 1.0, 0), (3, 0.37, 5)):
        got, n = mt.bench_audio(batch, seconds, seed)
        want, jn = bench._bench_audio(batch, seconds, seed)
        want = np.asarray(want)
        assert n == jn and got.shape == want.shape == (batch, 1, n)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def _write(folder: Path, name: str, seconds: float, seed: int, channels: int = 1,
           sr: int = 44100):
    x = np.random.RandomState(seed).uniform(-0.5, 0.5, (channels, int(sr * seconds)))
    write_wav(folder / name, x.astype(np.float32), sr)


def test_probe_corpus_reads_what_jax_reads(tmp_path):
    """Ten wavs of several lengths, some stereo, written out of order."""
    model = SimpleNamespace(sample_rate=44100)
    folder = tmp_path / "probe"
    folder.mkdir()
    for i in (9, 3, 0, 7, 1, 8, 2, 6, 4, 5):
        _write(folder, f"clip_{i:02d}.wav", 0.1 + 0.01 * ((7 * i) % 10), i,
               channels=1 + i % 2)
    (folder / "notes.txt").write_text("not audio")
    got, want = fast._probe_corpus(model, folder), jfast._probe_corpus(model, folder)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and got.shape[:2] == (8, 1)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("case", ["missing", "empty", "off_rate"])
def test_probe_corpus_is_none_where_jaxs_is(tmp_path, case):
    model = SimpleNamespace(sample_rate=44100)
    folder = tmp_path / "probe"
    if case != "missing":
        folder.mkdir()
    if case == "off_rate":
        _write(folder, "a.wav", 0.1, 0)
        _write(folder, "b.wav", 0.1, 1, sr=22050)
    assert fast._probe_corpus(model, folder) is None
    assert jfast._probe_corpus(model, folder) is None
