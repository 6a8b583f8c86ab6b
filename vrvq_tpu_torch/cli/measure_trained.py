"""The serving gates, the packed decoders' agreement and the serving
profiles' times on a TRAINED checkpoint, the counterpart of
``scripts/measure_r4.py`` (which covers ``scripts/measure_packed.py`` too)::

    python -m vrvq_tpu_torch.cli.measure_trained [batch seconds ckpt_dir probe_dir] \
        [--device cpu]

Defaults ``16 10.0 ckpt/synth_demo data_synth/test``: the flagship of
``conf/vrvq/vrvq_a2_synth_demo.yml`` with the generator of ``ckpt_dir``'s
``latest`` checkpoint (``cli.train --save_path``), on the card unless
``--device cpu`` is given. A checkpoint under 1000 steps is refused: a
near-init model's argmax near ties make the gates' verdicts meaningless.
``probe_dir`` is the gates' held-out corpus: the corpus the checkpoint
trained against, or another to cross them (``data_synth_rich/test``).

Prints one JSON line a measurement, flushed as it comes, with the JAX
script's keys in its order:

  1. ``ckpt_dir`` and ``probe_dir``;
  2. ``fast.turbo_gate`` of the turbo profile and of turbo + packed encoder
     against the exact-codes fast profile on the probe (the deploy decision
     for each);
  3. the same codes (one encode of ``bench_audio(4, 2.0, seed=7)`` by the
     turbo profile) decoded by the fast decoder and by each packed decoder
     (``decode_packed`` 1, 2, ``decode_packed_up`` 1, 2): SNR in dB;
  4. five serving profiles at ``batch`` x ``seconds`` of ``bench_audio``
     (seed 0): the compress (``fast.encode_codes``, codes from the fused-RVQ
     kernel) and the compress + decompress, each the least of 5 host-clock
     times after a warm-up, each call ending in a synchronize of the card;
     the decompress as their difference and the real-time factor.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import disable_tf32, resolve_device
from ..config import REPO, Config, model_config
from ..infer import fast
from ..models.dac_vrvq import DAC_VRVQ
from ..train import checkpoint as ckpt

SAMPLE_RATE = 44100
SYNTH_DEMO_YAML = "conf/vrvq/vrvq_a2_synth_demo.yml"
MIN_STEPS = 1000
GATES = (("turbo_vs_exact_TRAINED", {}),
         ("packed_encoder_vs_exact_TRAINED", dict(encode_packed=True)))
PACKED_DECODERS = (("packed_decoder_1", dict(decode_packed=1)),
                   ("packed_decoder_2", dict(decode_packed=2)),
                   ("packed_up_decoder_1", dict(decode_packed_up=1)),
                   ("packed_up_decoder_2", dict(decode_packed_up=2)))
PROFILES = (
    ("turbo", {}),
    ("turbo_encpacked", dict(encode_packed=True)),
    ("turbo_encpacked_decup1", dict(encode_packed=True, decode_packed_up=1)),
    ("turbo_encpacked_decup2", dict(encode_packed=True, decode_packed_up=2)),
    ("turbo_encpacked_decpacked1", dict(encode_packed=True, decode_packed=1)),
)


def bench_audio(batch: int, seconds: float, seed: int) -> Tuple[np.ndarray, int]:
    """``batch`` rows of seeded noise (B, 1, n) float32 at 0.1 RMS, ``n`` the
    samples of ``seconds`` rounded up to the 512-sample hop: the JAX
    package's ``bench._bench_audio``, bit for bit."""
    n = ((int(seconds * SAMPLE_RATE) + 511) // 512) * 512
    rng = np.random.RandomState(seed)
    return rng.randn(batch, 1, n).astype(np.float32) * 0.1, n


def timeit(fn: Callable[[], None], n_iters: int = 5) -> float:
    """One warm-up call, then the least of ``n_iters`` host-clock times
    (seconds) of ``fn``, which ends in a synchronize of the device."""
    fn()
    times = []
    for _ in range(n_iters):
        start = time.perf_counter()
        fn()
        times.append(time.perf_counter() - start)
    return min(times)


def trained_flagship(ckpt_dir, min_steps: int = MIN_STEPS, device=None,
                     config: str = SYNTH_DEMO_YAML) -> DAC_VRVQ:
    """The codec of ``config`` (the flagship synth demo) on ``device`` (the
    card by default) with the generator of ``ckpt_dir``'s ``latest``
    checkpoint (relative paths from the repo root), in eval mode. A
    checkpoint under ``min_steps`` steps raises ``SystemExit``: gate
    verdicts on a near-init model are the near-tie artefact the gates exist
    to avoid."""
    path = REPO / ckpt_dir
    step = int(ckpt.load_metadata(path, tag="latest").get("step", 0))
    if step < min_steps:
        raise SystemExit(
            f"{ckpt_dir} is at step {step} (< {min_steps}): a near-init "
            "checkpoint gives meaningless gate verdicts (argmax near-tie "
            "density). Point at a trained checkpoint, e.g. the save_path of "
            f"cli.train on {SYNTH_DEMO_YAML}.")
    cfg = Config.load(config, base_dir=REPO)
    cfg["ckpt_dir"] = str(path)
    cfg["tag"] = "latest"
    disable_tf32()
    model = DAC_VRVQ(model_config(cfg))
    return ckpt.load_gen_params(cfg, model, resolve_device(
        "cuda" if device is None else device)).eval()


def gate_line(name: str, res: fast.GateResult) -> Dict:
    return {
        "gate": name,
        "agreement_db": round(res.agreement_db, 1),
        "min_clip_agreement_db": round(res.min_clip_agreement_db, 1),
        "clip_agreement_db": [round(d, 1) for d in res.clip_agreement_db],
        "mask_agreement": round(res.mask_agreement, 5),
        "code_flip_rate": round(res.code_flip_rate, 5),
        "probe": res.probe,
        "passed": bool(res.passed),
    }


def _emit(line: Dict) -> None:
    print(json.dumps(line), flush=True)


def measure(model: DAC_VRVQ, batch: int = 16, seconds: float = 10.0,
            ckpt_dir: str = "ckpt/synth_demo", probe_dir: str = "data_synth/test",
            emit: Callable[[Dict], None] = _emit) -> List[Dict]:
    """Every line of the module's docstring for ``model`` (live, trained),
    each passed to ``emit`` as it is measured; returns them."""
    device = next(model.parameters()).device

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    lines = [{"ckpt_dir": ckpt_dir, "probe_dir": probe_dir}]
    emit(lines[0])
    for name, kw in GATES:
        lines.append(gate_line(name, fast.turbo_gate(model, probe_dir=probe_dir, **kw)))
        emit(lines[-1])

    with torch.inference_mode():
        probe = torch.from_numpy(bench_audio(4, 2.0, seed=7)[0]).to(device)
        base = fast.make_serving_model(model)
        codes, mask = fast.encode_codes(base, probe, 1.0)
        codes = codes.long()
        rec_base = base.decode_from_codes(codes, mask).cpu().numpy()
        for tag, kw in PACKED_DECODERS:
            packed = fast.make_serving_model(model, **kw)
            rec = packed.decode_from_codes(codes, mask).cpu().numpy()
            err = ((rec_base - rec) ** 2).sum()
            sig = (rec_base ** 2).sum()
            db = float("inf") if err == 0 else float(
                10 * np.log10(max(sig, 1e-12) / err))
            lines.append({"gate": f"{tag}_vs_base_TRAINED",
                          "agreement_db": round(db, 1)})
            emit(lines[-1])
        del probe, base, packed

        audio_np, n = bench_audio(batch, seconds, seed=0)
        audio = torch.from_numpy(audio_np).to(device)
        secs = batch * (n / SAMPLE_RATE)
        for name, kw in PROFILES:
            m = fast.make_serving_model(model, **kw)

            def encode(m=m):
                fast.encode_codes(m, audio, 1.0)
                sync()

            def forward(m=m):
                c, msk = fast.encode_codes(m, audio, 1.0)
                m.decode_from_codes(c.long(), msk)[:, :, ::1000].sum()
                sync()

            dt_enc, dt_fwd = timeit(encode), timeit(forward)
            lines.append({
                "profile": name,
                "encode_ms": round(dt_enc * 1e3, 1),
                "forward_ms": round(dt_fwd * 1e3, 1),
                "decode_ms_in_fwd": round((dt_fwd - dt_enc) * 1e3, 1),
                "rtf": round(secs / dt_fwd, 1),
            })
            emit(lines[-1])
            del m
    return lines


def parse(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="python -m vrvq_tpu_torch.cli.measure_trained",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("batch", type=int, nargs="?", default=16)
    ap.add_argument("seconds", type=float, nargs="?", default=10.0)
    ap.add_argument("ckpt_dir", nargs="?", default="ckpt/synth_demo")
    ap.add_argument("probe_dir", nargs="?", default="data_synth/test")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    args = parse(argv)
    model = trained_flagship(args.ckpt_dir, device=args.device)
    return measure(model, args.batch, args.seconds, args.ckpt_dir, args.probe_dir)


if __name__ == "__main__":
    main(sys.argv[1:])
