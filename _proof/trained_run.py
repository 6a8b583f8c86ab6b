"""The trained path on the card, through the port's entry points, at full
width: both corpora from cli.make_synth_dataset, cli.train of the synth demo,
cli.measure_trained with both probes, cli.evaluate at the 12 default levels
with ViSQOL in the live and the fast profile, the entropy-coded .dac against
the bit-packed one at level 1.0, the card's codes against the card machine's
CPU and the bfloat16 encoder's; and the rate-distortion diagnostics of a
trained checkpoint (``diagnose``): the folded decoders against the live one
on the same codes, the trainer's val mel recomputed, ``cli.evaluate --fast
0`` on the val clips at level 1.0, the importance map and the stages a frame
keeps, and the curves held against the JAX package's ``eval_demo.json``.

    python _proof/trained_run.py [--deadline_s 2700] [--out DIR] [--seed N]
        [--rate_distortion_only]
    python _proof/trained_run.py --compare EVAL_JSON [EVAL_JSON ...]

``--seed N`` trains with the config's ``seed`` set to N, into
``ckpt/synth_demo_seed<N>``; ``--rate_distortion_only`` skips the rich
corpus, ``measure_trained``, the entropy ``.dac``, the card against the CPU
and the bfloat16 encoder, so that a run of 4000 updates and its diagnostics
fit one call of 3600 s (``--deadline_s 3150``). ``--compare`` needs no card:
it prints, for each ``cli.evaluate`` report, its curve against the JAX
package's (``curve_against_jax``).

Writes its logs and JSON into ``--out`` (``_proof/out``) and prints one JSON
line a step (``steps.jsonl`` keeps them). Training killed at ``--deadline_s``
seconds after the start keeps the last checkpoint, which the trainer saves
at every ``valid_freq``-th step and the last; a checkpoint under
``measure_trained``'s floor of 1000 steps is not measured. A step of the
corpus, the training or ``measure_trained`` that fails ends the run; a
failed measurement after them is written as its step's ``error`` and the
run goes on, then exits with code 1.
"""

import argparse
import hashlib
import json
import signal
import subprocess
import sys
import time
import traceback
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
OUT = REPO / "_proof" / "out"
T0 = time.time()
SAVE = "ckpt/synth_demo"
YAML = "conf/vrvq/vrvq_a2_synth_demo.yml"
MEASURE = ["16", "10.0"]  # measure_trained's batch x seconds, JAX's defaults
PERSIST = REPO / "ckpt" / "persist_probe.txt"
JAX_CURVE = REPO / "eval_demo.json"  # the JAX package's 4000-step synth demo (TPU v5e)
# "on JAX's curve": within these of JAX's curve, interpolated at the port's
# kbps, at ON_CURVE_LEVELS or more of the 12 levels
ON_CURVE_SI_SDR_DB, ON_CURVE_MEL, ON_CURVE_LEVELS = 0.5, 0.1, 10
FAILED = []
DEVICE = None  # the card; "cpu" rehearses the diagnostics at a small config


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


def corpora(rich: bool = True):
    """The harmonic corpus; with ``rich`` the rich one is written while the
    model trains (``finish_rich``)."""
    py = [sys.executable, "-m", "vrvq_tpu_torch.cli.make_synth_dataset"]
    rc, _, s = run(py + ["--out", "data_synth"], "corpus_data_synth", timeout=900)
    assert rc == 0
    emit("corpus", corpus="data_synth", seconds=s, digest=digest(REPO / "data_synth"),
         printed=(OUT / "corpus_data_synth.out").read_text().splitlines())
    if not rich:
        return None
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


def train(deadline, seed=None):
    cmd = [sys.executable, "-m", "vrvq_tpu_torch.cli.train", "--args.load", YAML,
           "--save_path", SAVE] + ([] if seed is None else ["--seed", str(seed)])
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


def evaluate(fast: int, data_dir: str = "data_synth/test", tag: str = "",
             extra=("--num_examples", "8", "--duration", "2.0", "--visqol", "1")):
    """``cli.evaluate`` of the checkpoint on ``data_dir`` in the fast
    (``fast`` 1) or the live (0) profile, into ``eval_fast<fast><tag>.json``;
    its report and, at the 12 default levels, its curve against JAX's."""
    name = f"eval_fast{fast}{tag}"
    rc, _, s = run([sys.executable, "-m", "vrvq_tpu_torch.cli.evaluate",
                    "--args.load", YAML, "--ckpt_dir", SAVE, "--tag", "latest",
                    "--data_dir", data_dir, "--fast", str(fast), *extra,
                    "--out", str(OUT / f"{name}.json")], name, timeout=1500)
    assert rc == 0, (OUT / f"{name}.err").read_text()[-3000:]
    report = json.loads((OUT / f"{name}.json").read_text())
    if len(report["levels"]) == 12:
        report["against_jax"] = curve_against_jax(report)
    emit(name, rc=rc, seconds=s, data_dir=data_dir, **report)


def curve_against_jax(report) -> dict:
    """A ``cli.evaluate`` report's 12 levels against the JAX package's curve
    (``eval_demo.json``), interpolated linearly in kbps at the report's kbps
    (held at its ends outside JAX's range): the SI-SDR and mel differences a
    level and whether the curve is on JAX's (``ON_CURVE_*``)."""
    import numpy as np

    def curve(rep):
        rows = sorted((v["kbps"], v["SI-SDR"]["mean"], v["mel"]["mean"])
                      for v in rep["levels"].values())
        return [np.array(c) for c in zip(*rows)]

    jk, js, jm = curve(json.loads(JAX_CURVE.read_text()))
    k, si, mel = curve(report)
    d_si = si - np.interp(k, jk, js)
    d_mel = mel - np.interp(k, jk, jm)
    near = (np.abs(d_si) <= ON_CURVE_SI_SDR_DB) & (np.abs(d_mel) <= ON_CURVE_MEL)
    return {"kbps": k.tolist(), "si_sdr_minus_jax_db": d_si.tolist(),
            "mel_minus_jax": d_mel.tolist(), "levels_on_jax_curve": int(near.sum()),
            "on_jax_curve": bool(near.sum() >= ON_CURVE_LEVELS),
            "kbps_outside_jax_range": int(((k < jk[0]) | (k > jk[-1])).sum())}


def attempt(step: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``; a failure is written as ``step``'s error and
    the run goes on (it exits with code 1 at its end)."""
    try:
        fn(*args, **kwargs)
    except Exception:  # the run's boundary: record it, measure the rest
        FAILED.append(step)
        emit(step, error=traceback.format_exc()[-3000:])


def diagnose(seed=None):
    """The rate-distortion diagnostics of the checkpoint, in this process:
    the val mel of its last validation recomputed by the trainer's val step;
    at level 1.0 on the test clips, the folded decoders (the fast profile's
    bfloat16 + polynomial Snake, and each of its three changes alone) against
    the live float32 decoder on the live encoder's codes (SI-SDR a clip), the
    importance map's mean and quantiles and the stages a frame keeps."""
    import numpy as np
    import torch

    import vrvq_tpu_torch as port
    from vrvq_tpu_torch.cli import measure_trained as mt
    from vrvq_tpu_torch.config import Config
    from vrvq_tpu_torch.data.audio_io import read_audio
    from vrvq_tpu_torch.infer.fast import make_inference_model, serving_model
    from vrvq_tpu_torch.losses import L1Loss, MelSpectrogramLoss, MultiScaleSTFTLoss
    from vrvq_tpu_torch.metrics import si_sdr
    from vrvq_tpu_torch.train.loop import make_val_step
    from vrvq_tpu_torch.train.trainer import build_dataset, prepare_audio

    cfg = Config.load(YAML, base_dir=REPO)
    model = mt.trained_flagship(REPO / SAVE, min_steps=0, device=DEVICE,
                                 config=YAML)
    device = next(model.parameters()).device
    meta = json.loads((REPO / SAVE / "latest" / "meta.json").read_text())
    logged = meta.get("tracker", {}).get("history", {}).get("val", [])

    # the trainer's validation, as train() runs it (val_batch_size batches)
    mel_kw = cfg.kwargs("MelSpectrogramLoss")
    mel_kw.setdefault("sample_rate", model.sample_rate)
    val_step = make_val_step(MultiScaleSTFTLoss(**cfg.kwargs("MultiScaleSTFTLoss")),
                             MelSpectrogramLoss(**mel_kw), L1Loss())
    val_data = build_dataset(cfg, model.sample_rate, "val")
    bs = int(cfg.get("val_batch_size", 10))
    mels = []
    for start in range(0, len(val_data), bs):
        idxs = range(start, min(start + bs, len(val_data)))
        audio = prepare_audio(val_data, val_data.collate([val_data[i] for i in idxs]),
                              device)
        mels.append(float(val_step(model, audio)["mel/loss"]))
    emit("val_mel_recomputed", seed=seed, recomputed=float(np.mean(mels)),
         batches=mels, logged_last=logged[-1] if logged else None,
         items=len(val_data), excerpt_s=val_data.duration)

    variants = {
        "fast_profile": serving_model(model, True),
        "folded_f32_exact_snake": make_inference_model(
            model, decode_dtype="float32", snake_approx=False),
        "folded_f32_polynomial_snake": make_inference_model(
            model, decode_dtype="float32", snake_approx=True),
        "folded_bf16_exact_snake": make_inference_model(model, snake_approx=False),
    }
    n_q, bits = model.n_codebooks, float(np.log2(model.config.codebook_size))
    frame_rate = model.sample_rate / model.hop_length
    rows = []
    for path in sorted((REPO / "data_synth" / "test").glob("*.wav")):
        data, rate = read_audio(path)
        assert rate == model.sample_rate, (path, rate)
        x = torch.from_numpy(np.asarray(data, np.float32)[None, :1]).to(device)
        with torch.inference_mode():
            audio = model.preprocess(x, rate)
            enc = model.encode(audio, level=1.0)
            codes, mask = enc["codes"], enc["mask_imp"]
            live = model.decode_from_codes(codes, mask)
            row = {"clip": path.name}
            for name, variant in variants.items():
                out = variant.decode_from_codes(codes, mask).float()
                row[f"{name}_si_sdr_db"] = si_sdr(out, live)
            imp = enc["imp_map"].float().cpu().numpy().ravel()
            stages = mask.float().sum(1).cpu().numpy().ravel()
        row.update(imp_map_mean=float(imp.mean()),
                   imp_map_quantiles=np.quantile(imp, [0.1, 0.5, 0.9]).tolist(),
                   stages_a_frame=float(stages.mean()),
                   kbps_of_stages=float(stages.mean() * frame_rate * bits / 1e3),
                   level_1_x_nq_times_imp=float(imp.mean() * n_q))
        rows.append(row)
    summary = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]
               if k not in ("clip", "imp_map_quantiles")}
    summary.update({f"{k}_min": float(np.min([r[k] for r in rows]))
                    for k in rows[0] if k.endswith("_si_sdr_db")})
    emit("decode_and_imp_map", seed=seed, level=1.0, clips=len(rows), **summary,
         per_clip=rows)


def per_clip_curves():
    """``cli.evaluate`` of each test clip alone at the 12 default levels, in
    the fast and the live profile (in this process, each model loaded once),
    and the curves those compose: the mean over the 8 clips (which the
    whole-folder evaluation reports) and the mean over the clips the JAX
    package's ``eval_demo.json`` scored. That evaluation called the loader
    with ``RandomState(idx)`` and no ``global_idx``, so its 8 examples were
    8 draws of a clip (``round3_draws``, here drawn again with the port's
    loader), not the 8 clips; each composed curve against JAX's."""
    import contextlib
    import io
    import tempfile

    import numpy as np

    from vrvq_tpu_torch import resolve_device
    from vrvq_tpu_torch.cli import evaluate as cli_eval
    from vrvq_tpu_torch.config import parse_args
    from vrvq_tpu_torch.data.loaders import AudioLoader

    test = REPO / "data_synth" / "test"
    clips = sorted(p.name for p in test.glob("*.wav"))
    loader = AudioLoader(sources=[str(test)], shuffle=False)
    draws = [Path(loader(state=np.random.RandomState(idx), sample_rate=44100,
                         duration=2.0, num_channels=1)["path"]).name
             for idx in range(len(clips))]
    (OUT / "per_clip").mkdir(exist_ok=True)
    for fast in (1, 0):
        cfg = parse_args(["--args.load", YAML, "--ckpt_dir", SAVE, "--tag", "latest",
                          "--num_examples", "1", "--duration", "2.0"], base_dir=REPO)
        device = resolve_device("cuda" if DEVICE is None else DEVICE)
        model = cli_eval.load_model(cfg, device, fast=bool(fast))
        per_clip = {}
        for clip in clips:
            with tempfile.TemporaryDirectory() as tmp:
                (Path(tmp) / clip).symlink_to(test / clip)
                cfg["data_dir"] = tmp
                cfg["out"] = str(OUT / "per_clip" / f"fast{fast}_{clip}.json")
                with contextlib.redirect_stdout(io.StringIO()):
                    per_clip[clip] = cli_eval.evaluate(cfg, model=model)["levels"]
        del model

        def compose(names):
            return {"levels": {lv: {
                "kbps": float(np.mean([per_clip[c][lv]["kbps"] for c in names])),
                **{m: {"mean": float(np.mean([per_clip[c][lv][m]["mean"]
                                              for c in names]))}
                   for m in ("SI-SDR", "mel")}}
                for lv in per_clip[clips[0]]}}

        curves = {"all_8_clips": compose(clips), "round3_clips": compose(draws)}
        emit(f"per_clip_fast{fast}", round3_draws=draws,
             per_clip={c: {lv: {"kbps": v["kbps"], "SI-SDR": v["SI-SDR"]["mean"],
                                "mel": v["mel"]["mean"]} for lv, v in levels.items()}
                       for c, levels in per_clip.items()},
             **{name: {"levels": {lv: {"kbps": v["kbps"], "SI-SDR": v["SI-SDR"]["mean"],
                                       "mel": v["mel"]["mean"]}
                                  for lv, v in curve["levels"].items()},
                       "against_jax": curve_against_jax(curve)}
                for name, curve in curves.items()})


def parameter_stats():
    """The trained generator's Snake alphas and the ratio of each weight-normed
    layer's ``g`` to ``||v||`` (1 at init): the range the folded decoder
    and the polynomial Snake meet."""
    import numpy as np
    import torch

    from vrvq_tpu_torch.cli import measure_trained as mt

    model = mt.trained_flagship(REPO / SAVE, min_steps=0, device="cpu", config=YAML)
    out = {}
    for part in ("encoder", "decoder"):
        alphas, ratios = [], []
        for name, module in getattr(model, part).named_modules():
            if hasattr(module, "alpha") and isinstance(module.alpha, torch.Tensor):
                alphas.append(module.alpha.detach().abs().flatten())
            if hasattr(module, "g") and getattr(module, "v", None) is not None \
                    and module.v.dim() == 3:  # the convs: g over v's dim 0
                v = module.v.detach()
                ratios.append(module.g.detach().flatten()
                              / v.norm(dim=(1, 2)).clamp_min(1e-30))
        a, r = torch.cat(alphas).numpy(), torch.cat(ratios).numpy()
        out[part] = {"alpha_quantiles": np.quantile(a, [0, 0.01, 0.5, 0.99, 1]).tolist(),
                     "g_over_norm_v_quantiles": np.quantile(
                         r, [0, 0.01, 0.5, 0.99, 1]).tolist(),
                     "snakes": len(alphas), "weight_normed": len(ratios)}
    emit("parameter_stats", **out)


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
    global OUT, SAVE
    ap = argparse.ArgumentParser()
    ap.add_argument("--deadline_s", type=float, default=2700.0)
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--rate_distortion_only", action="store_true")
    ap.add_argument("--compare", type=Path, nargs="+", default=None)
    args = ap.parse_args()
    if args.compare:
        for path in args.compare:
            print(json.dumps({"report": str(path), **curve_against_jax(
                json.loads(path.read_text()))}))
        return
    OUT = args.out if args.out.is_absolute() else REPO / args.out
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "steps.jsonl").write_text("")
    if args.seed is not None:
        SAVE = f"ckpt/synth_demo_seed{args.seed}"
    import torch

    from vrvq_tpu_torch.cli.measure_trained import MIN_STEPS

    emit("start", smi=smi(), python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, persisted_from_an_earlier_call=PERSIST.exists(),
         args={"deadline_s": args.deadline_s, "out": str(args.out), "seed": args.seed,
               "rate_distortion_only": args.rate_distortion_only, "save": SAVE})
    PERSIST.parent.mkdir(parents=True, exist_ok=True)
    PERSIST.write_text(str(T0))
    rich = corpora(rich=not args.rate_distortion_only)
    step = train(T0 + args.deadline_s, args.seed)
    if rich is not None:
        finish_rich(rich)
    if step < MIN_STEPS:
        raise SystemExit(f"{SAVE} stopped at step {step}, under measure_trained's "
                         f"floor of {MIN_STEPS}: nothing measured")
    if not args.rate_distortion_only:
        measure()
    for fast in (0, 1):
        attempt(f"eval_fast{fast}", evaluate, fast)
    # the val clips at level 1.0, live: whole 2 s clips and the trainer's
    # excerpt length
    for tag, seconds in (("_val", "2.0"), ("_val_excerpt", "0.38314059")):
        attempt(f"eval_fast0{tag}", evaluate, 0, "data_synth/val", tag,
                ("--num_examples", "16", "--duration", seconds, "--levels", "1.0"))
    attempt("diagnose", diagnose, args.seed)
    attempt("per_clip", per_clip_curves)
    attempt("parameter_stats", parameter_stats)
    if not args.rate_distortion_only:
        attempt("in_process", in_process)
    emit("end", smi=smi(), failed=FAILED)
    if FAILED:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
