"""The trained path on the card, through the port's entry points, at full
width: both corpora from cli.make_synth_dataset, cli.train of the synth demo,
cli.measure_trained with both probes, cli.evaluate at the 12 default levels
with ViSQOL, the entropy-coded .dac against the bit-packed one at level 1.0,
the card's codes against the card machine's CPU and the bfloat16 encoder's.

    python _proof/trained_run.py [--deadline_s 2700] [--out DIR]

Writes its logs and JSON into ``--out`` (``_proof/out``) and prints one JSON
line a step (``steps.jsonl`` keeps them). Training killed at ``--deadline_s``
seconds after the start keeps the last checkpoint, which the trainer saves
at every ``valid_freq``-th step and the last; a checkpoint under
``measure_trained``'s floor of 1000 steps is not measured. A step that
fails ends the run.
"""

import argparse
import hashlib
import json
import signal
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
OUT = REPO / "_proof" / "out"
T0 = time.time()
SAVE = "ckpt/synth_demo"
YAML = "conf/vrvq/vrvq_a2_synth_demo.yml"
MEASURE = ["16", "10.0"]  # measure_trained's batch x seconds, JAX's defaults
PERSIST = REPO / "ckpt" / "persist_probe.txt"


def emit(name, **fields):
    line = {"step": name, "t_s": round(time.time() - T0, 1), **fields}
    print(json.dumps(line), flush=True)
    with open(OUT / "steps.jsonl", "a") as f:
        f.write(json.dumps(line) + "\n")


def digest(root: Path):
    out = {}
    for split in ("train", "val", "test"):
        h = hashlib.sha256()
        files = sorted((root / split).glob("*.wav"))
        for p in files:
            h.update(p.name.encode())
            h.update(p.read_bytes())
        out[split] = [len(files), h.hexdigest()]
    return out


def run(cmd, log: str, timeout=None, deadline=None):
    """``cmd`` from the repo root, stdout and stderr into OUT/<log>.*; killed
    at ``deadline`` (time.time()) if it is still running then."""
    t = time.time()
    with open(OUT / f"{log}.out", "w") as so, open(OUT / f"{log}.err", "w") as se:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=so, stderr=se)
        killed = False
        while proc.poll() is None:
            if deadline is not None and time.time() > deadline:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                killed = True
                break
            if timeout is not None and time.time() - t > timeout:
                proc.kill()
                proc.wait()
                killed = True
                break
            time.sleep(0.5)
    return proc.returncode, killed, time.time() - t


def smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def corpora():
    """The harmonic corpus; the rich one is written while the model trains
    (``finish_rich``)."""
    py = [sys.executable, "-m", "vrvq_tpu_torch.cli.make_synth_dataset"]
    rc, _, s = run(py + ["--out", "data_synth"], "corpus_data_synth", timeout=900)
    assert rc == 0
    emit("corpus", corpus="data_synth", seconds=s, digest=digest(REPO / "data_synth"),
         printed=(OUT / "corpus_data_synth.out").read_text().splitlines())
    log = open(OUT / "corpus_data_synth_rich.out", "w")
    rich = subprocess.Popen(py + ["--out", "data_synth_rich", "--classes", "all",
                                  "--seed", "7", "--train", "384"],
                            cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
    return rich, time.time(), log


def finish_rich(started):
    rich, t, log = started
    rc = rich.wait()
    log.close()
    assert rc == 0, (OUT / "corpus_data_synth_rich.out").read_text()[-3000:]
    emit("corpus", corpus="data_synth_rich", rc=rc, seconds_since_start=time.time() - t,
         digest=digest(REPO / "data_synth_rich"),
         printed=(OUT / "corpus_data_synth_rich.out").read_text().splitlines())


def train(deadline):
    cmd = [sys.executable, "-m", "vrvq_tpu_torch.cli.train", "--args.load", YAML,
           "--save_path", SAVE]
    rc, killed, s = run(cmd, "train", deadline=deadline)
    assert rc == 0 or killed, (OUT / "train.err").read_text()[-3000:]
    meta = json.loads((REPO / SAVE / "latest" / "meta.json").read_text())
    hist = meta.get("tracker", {}).get("history", {})
    val = hist.get("val", [])
    summary = {}
    text = (OUT / "train.out").read_text().strip().splitlines()
    if text and text[-1].startswith("{"):
        import numpy as np

        full = json.loads(text[-1])
        step_ms = np.array(full["step_ms"])
        data_ms = np.array(full["data_ms"])
        every = max(1, len(full["metrics"]) // 80)
        summary = {
            "device": full["device"], "steps": full["steps"], "final_step": full["step"],
            "step_ms_median": float(np.median(step_ms)),
            "step_ms_mean": float(step_ms.mean()),
            "step_ms_first5": step_ms[:5].tolist(),
            "step_ms_p90": float(np.percentile(step_ms, 90)),
            "data_ms_median": float(np.median(data_ms)),
            "data_ms_max": float(data_ms.max()),
            "train_seconds_in_steps": float(step_ms.sum() / 1e3),
            "peak_memory_gib": full["peak_memory_gib"],
            "launches": full["launches"],
            "params_without_gradient": full["params_without_gradient"],
            "train_metrics_every": every,
            "train_metrics": [{"step": i, **m} for i, m in
                              enumerate(full["metrics"]) if i % every == 0
                              or i == len(full["metrics"]) - 1],
        }
        (OUT / "train.out").write_text("(the summary line is reduced into "
                                       "train_summary.json)\n")
    (OUT / "train_summary.json").write_text(json.dumps(summary))
    emit("train", rc=rc, killed_at_deadline=killed, seconds=s,
         latest_step=meta.get("step"), val=val,
         **{k: v for k, v in summary.items() if k != "train_metrics"})
    return int(meta.get("step", 0))


def measure():
    lines = {}
    for probe in ("data_synth/test", "data_synth_rich/test"):
        tag = probe.split("/")[0]
        rc, _, s = run([sys.executable, "-m", "vrvq_tpu_torch.cli.measure_trained",
                        *MEASURE, SAVE, probe], f"measure_{tag}", timeout=900)
        assert rc == 0, (OUT / f"measure_{tag}.err").read_text()[-3000:]
        lines[probe] = {"rc": rc, "seconds": s, "lines": [
            json.loads(ln) for ln in (OUT / f"measure_{tag}.out").read_text().splitlines()
            if ln.startswith("{")]}
    emit("measure_trained", **lines)


def evaluate():
    rc, _, s = run([sys.executable, "-m", "vrvq_tpu_torch.cli.evaluate",
                    "--args.load", YAML, "--ckpt_dir", SAVE, "--tag", "latest",
                    "--data_dir", "data_synth/test", "--num_examples", "8",
                    "--duration", "2.0", "--visqol", "1",
                    "--out", str(OUT / "eval.json")], "evaluate", timeout=1500)
    assert rc == 0, (OUT / "evaluate.err").read_text()[-3000:]
    emit("evaluate", rc=rc, seconds=s, **json.loads((OUT / "eval.json").read_text()))


def in_process():
    """The entropy .dac, the card against the CPU, the bfloat16 encoder."""
    import numpy as np
    import torch

    import chip_smoke as cs
    import vrvq_tpu_torch as port
    from vrvq_tpu_torch.cli import measure_trained as mt
    from vrvq_tpu_torch.data.audio_io import read_audio

    model = mt.trained_flagship(REPO / SAVE)
    cpu_model = mt.trained_flagship(REPO / SAVE, device="cpu")
    clips = sorted((REPO / "data_synth" / "test").glob("*.wav"))
    sr = model.sample_rate
    signals = []
    for p in clips:
        data, rate = read_audio(p)
        signals.append(port.Signal(np.asarray(data, np.float32)[None, :1], rate))

    # entropy-coded .dac against the bit-packed one, level 1.0
    tmp = OUT / "_dac"
    tmp.mkdir(exist_ok=True)
    proc = port.CodecProcessor(model, fused_quantizer=True)
    sizes = []
    for i, sig in enumerate(signals):
        dac = proc.compress(sig, level=1.0)
        k = model.config.codebook_size
        rc = dac.save(tmp / f"{i}_rc.dac", entropy=True, codebook_size=k)
        bp = dac.save(tmp / f"{i}_bp.dac", codebook_size=k)
        back = port.DACFile.load(rc)
        kept = np.arange(model.n_codebooks)[None, :, None] < dac.vbr_counts[:, None, :]
        assert np.array_equal(back.codes[kept], dac.codes[kept])
        sizes.append((rc.stat().st_size, bp.stat().st_size,
                      int(dac.vbr_counts.sum()), int(dac.vbr_counts.size)))
    secs = sum(s.signal_length / sr for s in signals)
    rc_b, bp_b = sum(s[0] for s in sizes), sum(s[1] for s in sizes)
    emit("entropy_dac", clips=len(signals), seconds=secs, range_coded_bytes=rc_b,
         bit_packed_bytes=bp_b, range_coded_kbps=rc_b * 8 / secs / 1e3,
         bit_packed_kbps=bp_b * 8 / secs / 1e3, saving=1 - rc_b / bp_b,
         per_clip=sizes,
         mean_codebooks_a_frame=sum(s[2] for s in sizes) / sum(s[3] for s in sizes))

    # the card's codes (K1, kernels) against the CPU's (plain), each clip
    # in 1 s windows at level 1.0; near ties from the CPU's margins
    totals = {}
    per_clip = []
    for sig in signals:
        card = port.CodecProcessor(model, fused_quantizer=True).compress(
            sig, win_duration=1.0, level=1.0)
        ref_proc = cs.MarginProcessor(cpu_model)
        ref = ref_proc.compress(sig, win_duration=1.0, level=1.0)
        near = np.concatenate(ref_proc.margins, axis=-1) <= cs.TIE_MARGIN
        split = cs.flips(card.codes, ref.codes, near)
        split["frames"] = int(card.codes.shape[0] * card.codes.shape[-1])
        split["mask_agreement"] = float((card.vbr_counts == ref.vbr_counts).mean())
        per_clip.append(split)
        for k, v in split.items():
            totals[k] = totals.get(k, 0) + v
    totals["code_flip_rate"] /= len(signals)
    totals["mask_agreement"] /= len(signals)
    emit("card_vs_cpu", tie_margin=cs.TIE_MARGIN, **totals, per_clip=per_clip)

    # the bfloat16 encoder profile against the exact fast profile
    gen = torch.Generator().manual_seed(0)
    rows = []
    for sig in signals:
        _, r = cs.bf16_encoder(model, sig, gen)
        rows.append({k: r[k] for k in ("code_share_differing_from_exact",
                                       "mask_agreement_with_exact",
                                       "decode_si_sdr_db_against_exact")})
    emit("bf16_encoder", clips=len(rows),
         code_share_differing_from_exact=float(np.mean(
             [r["code_share_differing_from_exact"] for r in rows])),
         mask_agreement_with_exact=float(np.mean(
             [r["mask_agreement_with_exact"] for r in rows])),
         decode_si_sdr_db_against_exact=float(np.mean(
             [r["decode_si_sdr_db_against_exact"] for r in rows])),
         per_clip=rows)


def main():
    global OUT
    ap = argparse.ArgumentParser()
    ap.add_argument("--deadline_s", type=float, default=2700.0)
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    OUT = args.out if args.out.is_absolute() else REPO / args.out
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "steps.jsonl").write_text("")
    import torch

    from vrvq_tpu_torch.cli.measure_trained import MIN_STEPS

    emit("start", smi=smi(), python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, persisted_from_an_earlier_call=PERSIST.exists(),
         args={"deadline_s": args.deadline_s, "out": str(args.out)})
    PERSIST.parent.mkdir(parents=True, exist_ok=True)
    PERSIST.write_text(str(T0))
    rich = corpora()
    step = train(T0 + args.deadline_s)
    finish_rich(rich)
    if step < MIN_STEPS:
        raise SystemExit(f"{SAVE} stopped at step {step}, under measure_trained's "
                         f"floor of {MIN_STEPS}: nothing measured")
    measure()
    evaluate()
    in_process()
    emit("end", smi=smi())


if __name__ == "__main__":
    main()
