"""The benchmark's audio: seeded synthetic clips.

``synthetic_clip`` is a frozen copy of ``vrvq_tpu_torch.audio.
synthetic_clip`` (four tones under a slow envelope, plus noise), kept here
so that a change to the program cannot move the benchmark's inputs.
``clips`` draws many such clips at once on the device, from one
``torch.Generator`` there: the same recipe, the phases and the noise from
the device's generator, in two calls."""

from __future__ import annotations

import math

import numpy as np
import torch

TONES = ((110.0, 0.2), (440.0, 0.15), (1250.0, 0.08), (3520.0, 0.04))


def synthetic_clip(seconds: float, sample_rate: int, seed: int) -> np.ndarray:
    """A seeded test clip, (1, 1, T) float32: four tones under a slow
    envelope, plus noise."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sample_rate)) / sample_rate
    x = np.zeros_like(t)
    for f, a in TONES:
        x += a * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
    x *= 0.6 + 0.4 * np.sin(2 * np.pi * 0.5 * t)
    x += 0.02 * rng.randn(t.size)
    return x.astype(np.float32)[None, None, :]


@torch.no_grad()
def clips(n: int, samples: int, sample_rate: int, generator: torch.Generator,
          device) -> torch.Tensor:
    """``n`` clips of ``samples`` samples, (n, samples) float32 on
    ``device``: ``synthetic_clip``'s recipe, each clip with its own tone
    phases and noise."""
    phases = torch.rand((n, len(TONES), 1), generator=generator, device=device,
                        dtype=torch.float64) * (2 * math.pi)
    noise = torch.randn((n, samples), generator=generator, device=device)
    t = torch.arange(samples, device=device, dtype=torch.float64) / sample_rate
    x = torch.zeros((n, samples), device=device, dtype=torch.float64)
    for i, (f, a) in enumerate(TONES):
        x += a * torch.sin(2 * math.pi * f * t + phases[:, i])
    x *= 0.6 + 0.4 * torch.sin(2 * math.pi * 0.5 * t)
    return (x + 0.02 * noise).float()
