"""Synthetic audio clips for training demos and measurements on a trained
checkpoint: the port's copy of the JAX package's corpus generator
(``scripts/make_synth_dataset.py``), numpy only.

Four classes of material (``CLIP_CLASSES``): harmonic stacks with vibrato
and note-onset envelopes, band-shaped percussive bursts, AM/FM speech-like
material and coloured-noise textures. ``synth_clip_with_classes`` draws one
clip from a ``numpy.random.RandomState``: a class (or a 2-class mix, a
quarter of the time, when more than one class is allowed; no class-pick draw
when one is), a noise floor and a peak level. Every draw is taken in the JAX
script's order and the arithmetic is its float64 arithmetic in its order,
cast to float32 at the end as it casts: the same generator state gives the
same clip bit for bit, so the harmonic corpus ``data_synth`` and the mixed
corpus ``data_synth_rich`` are the same bytes from either package.
``cli/make_synth_dataset.py`` writes the corpora.
"""

from __future__ import annotations

import numpy as np


def _harmonic(rng, t, sr, dur):
    """Music-like material: overlapping harmonic stacks with vibrato and
    exponential note-onset envelopes (the harmonic corpus, ``data_synth``;
    its draws in the JAX generator's order, so its bytes are JAX's)."""
    audio = np.zeros_like(t)
    for _ in range(rng.randint(2, 6)):
        f0 = rng.uniform(60.0, 1200.0)
        onset = rng.uniform(0.0, max(dur - 0.05, 0.0))
        decay = rng.uniform(0.3, 3.0)
        vib = rng.uniform(0.0, 6.0)  # vibrato Hz
        env = np.clip(t - onset, 0.0, None)
        env = (env > 0) * np.exp(-env * decay)
        phase = 2 * np.pi * (f0 * t + (f0 * 0.005 / max(vib, 1e-6))
                             * np.sin(2 * np.pi * vib * t) * (vib > 0))
        for h in range(1, rng.randint(4, 12)):
            amp = rng.uniform(0.2, 1.0) / h
            audio += amp * env * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
    return audio


def _percussion(rng, t, sr, dur):
    """Transient material: sharp-onset band-shaped noise bursts (drum-like
    hits), the class the harmonic corpus lacks entirely — exercises the
    codec's time resolution and the MPD/MRD discriminators' transient
    sensitivity."""
    n = len(t)
    audio = np.zeros(n)
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    for _ in range(rng.randint(3, 10)):
        onset = rng.uniform(0.0, 0.95) * dur
        decay = rng.uniform(8.0, 80.0)  # fast: 12-125 ms tails
        env = np.clip(t - onset, 0.0, None)
        env = (env > 0) * np.exp(-env * decay)
        burst = rng.randn(n) * env
        # band-shape the hit around a random center (log-uniform)
        fc = 10 ** rng.uniform(np.log10(80.0), np.log10(10000.0))
        bw = fc * rng.uniform(0.3, 1.5)
        shape = np.exp(-0.5 * ((freqs - fc) / bw) ** 2)
        shaped = np.fft.irfft(np.fft.rfft(burst) * shape, n)
        # optional pitched body under the hit (kick/tom-like)
        if rng.rand() < 0.5:
            fb = rng.uniform(40.0, 200.0)
            shaped += 0.8 * env * np.sin(
                2 * np.pi * fb * (t - onset) * (1 + 2 * env))
        audio += rng.uniform(0.4, 1.0) * shaped
    return audio


def _speech_like(rng, t, sr, dur):
    """AM/FM speech-like material: a glottal-style harmonic source with a
    random-walk pitch contour, three formant resonances evaluated per
    harmonic (time-varying spectral envelope), syllabic (3-8 Hz)
    amplitude modulation, and interleaved unvoiced noise segments."""
    n = len(t)
    # f0 contour: smoothed random walk in 80-300 Hz
    steps = rng.randn(n) * 2.0
    f0 = 10 ** (np.log10(rng.uniform(90.0, 220.0))
                + np.cumsum(steps) / sr * rng.uniform(0.2, 1.0))
    f0 = np.clip(f0, 80.0, 300.0)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    # three formants with slow random drift
    audio = np.zeros(n)
    drift = np.sin(2 * np.pi * rng.uniform(0.3, 1.5) * t
                   + rng.uniform(0, 2 * np.pi, size=(3, 1)))
    centers = (np.array([[500.0], [1500.0], [2500.0]])
               * (1 + 0.25 * drift) * rng.uniform(0.8, 1.25, size=(3, 1)))
    bws = np.array([[80.0], [120.0], [200.0]]) * rng.uniform(0.8, 1.5)
    n_harm = int(4000.0 / f0.min())
    for h in range(1, min(n_harm, 48) + 1):
        fh = h * f0  # (n,) time-varying harmonic frequency
        gain = np.zeros(n)
        for fmt in range(3):
            gain += np.exp(-0.5 * ((fh - centers[fmt]) / bws[fmt, 0]) ** 2)
        audio += (gain + 0.02) / h * np.sin(h * phase)
    # syllabic AM: 3-8 Hz raised cosine, gated to voiced segments
    syl = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(3.0, 8.0) * t
                            + rng.uniform(0, 2 * np.pi)))
    voiced = syl ** rng.uniform(1.0, 3.0)
    audio *= voiced
    # unvoiced: high-passed noise in the AM troughs (fricative-like)
    noise = rng.randn(n)
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    hp = 1.0 / (1.0 + np.exp(-(freqs - 2500.0) / 400.0))
    noise = np.fft.irfft(np.fft.rfft(noise) * hp, n)
    audio += 0.3 * noise * (1 - voiced) * (rng.rand() < 0.8)
    return audio


def _noise_texture(rng, t, sr, dur):
    """Colored-noise texture with a slowly time-varying amplitude — the
    hardest class for a low-rate codec (no harmonic structure to spend
    bits on) and a probe of the rate loss's behavior on dense spectra."""
    n = len(t)
    freqs = np.fft.rfftfreq(n, 1.0 / sr)
    alpha = rng.uniform(0.0, 2.0)  # white..brown
    mag = 1.0 / np.maximum(freqs, 20.0) ** (alpha / 2)
    lo = 10 ** rng.uniform(np.log10(50.0), np.log10(2000.0))
    hi = lo * 10 ** rng.uniform(0.3, 1.5)
    band = ((freqs > lo) & (freqs < hi)).astype(float)
    mag *= 0.2 + band
    noise = np.fft.irfft(np.fft.rfft(rng.randn(n)) * mag, n)
    am = 0.4 + 0.6 * 0.5 * (1 + np.sin(
        2 * np.pi * rng.uniform(0.3, 4.0) * t + rng.uniform(0, 2 * np.pi)))
    return noise * am


CLIP_CLASSES = {
    "harmonic": _harmonic,
    "percussion": _percussion,
    "speech": _speech_like,
    "noise": _noise_texture,
}


def synth_clip_with_classes(rng: np.random.RandomState, sr: int, dur: float,
                            classes=("harmonic",)):
    """One clip from a randomly drawn class (or a 2-class mix, 25% of the
    time, when more than one class is allowed). Returns (audio, picks) so
    callers can tag files with their class for per-class evaluation."""
    n = int(sr * dur)
    t = np.arange(n) / sr
    names = list(classes)
    if len(names) == 1:
        # no class-pick draw: the single-class (harmonic) corpus keeps its
        # bytes from the same seed
        picks = names
    else:
        picks = [names[rng.randint(len(names))]]
        if rng.rand() < 0.25:
            picks.append(names[rng.randint(len(names))])
    audio = np.zeros(n, np.float64)
    for name in picks:
        audio += CLIP_CLASSES[name](rng, t, sr, dur) / len(picks)
    audio += rng.randn(n) * 10 ** rng.uniform(-4.0, -2.5)  # noise floor
    peak = np.abs(audio).max()
    if peak > 0:
        audio *= rng.uniform(0.1, 0.9) / peak
    return audio.astype(np.float32), picks


def synth_clip(rng: np.random.RandomState, sr: int, dur: float,
               classes=("harmonic",)) -> np.ndarray:
    return synth_clip_with_classes(rng, sr, dur, classes)[0]
