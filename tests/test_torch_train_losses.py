"""The port's spectral ops and training losses against the JAX package's.

``stft``, ``mel_filterbank``, ``mel_spectrogram`` and ``istft`` within rtol
1e-5 (atol 1e-5 of the spectrum's scale); every loss's value within rtol 1e-5
and its gradient with respect to the input within a per-element rtol of 1e-4
of ``jax.grad`` (atol 1e-4 of the gradient's largest element: an element near
zero has no relative error to speak of); the LSGAN losses on the same feature
maps. Inputs are seeded numpy arrays handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.losses import gan as jgan
from vrvq_tpu.losses import recon as jrecon
from vrvq_tpu.ops import stft as jstft
from vrvq_tpu_torch.losses import gan as tgan
from vrvq_tpu_torch.losses import recon as trecon
from vrvq_tpu_torch.ops import stft as tstft

torch.set_num_threads(1)
SR = 44100


def _audio(seed, shape=(2, 1, 3000)):
    rng = np.random.RandomState(seed)
    return (0.3 * rng.randn(*shape)).astype(np.float32)


def _close(got, want, rtol=1e-5, scale_atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=scale_atol * float(np.max(np.abs(want))))


@pytest.mark.parametrize("match_stride", [False, True])
@pytest.mark.parametrize("window", [512, 128])
def test_stft_matches_jax(window, match_stride):
    x = _audio(0)
    got = tstft.stft(torch.from_numpy(x), window, window // 4, None, match_stride)
    want = jstft.stft(jnp.asarray(x), window, window // 4, None, match_stride)
    assert tuple(got.shape) == want.shape
    _close(got.real.numpy(), np.real(want))
    _close(got.imag.numpy(), np.imag(want))


@pytest.mark.parametrize("n_fft,n_mels,fmax", [(2048, 320, None), (512, 40, None),
                                               (256, 20, 8000.0)])
def test_mel_filterbank_matches_jax(n_fft, n_mels, fmax):
    np.testing.assert_allclose(tstft.mel_filterbank(SR, n_fft, n_mels, 0.0, fmax),
                               jstft.mel_filterbank(SR, n_fft, n_mels, 0.0, fmax),
                               rtol=1e-5, atol=1e-7)


def test_mel_spectrogram_matches_jax():
    x = _audio(1)
    got = tstft.mel_spectrogram(torch.from_numpy(x), SR, 40, 512, 128)
    want = jstft.mel_spectrogram(jnp.asarray(x), SR, 40, 512, 128)
    _close(got.numpy(), want)


def test_istft_matches_jax():
    x = _audio(2)
    spec = jstft.stft(jnp.asarray(x), 512, 128)
    want = jstft.istft(spec, 512, 128, x.shape[-1])
    got = tstft.istft(torch.from_numpy(np.array(spec)), 512, 128, x.shape[-1])
    _close(got.numpy(), want)
    _close(got.numpy(), x, scale_atol=1e-5)  # and it inverts


LOSSES = {
    "l1": (trecon.L1Loss(), jrecon.L1Loss()),
    "l2": (trecon.L2Loss(), jrecon.L2Loss()),
    "sisdr": (trecon.SISDRLoss(), jrecon.SISDRLoss()),
    "stft": (trecon.MultiScaleSTFTLoss(window_lengths=(512, 128)),
             jrecon.MultiScaleSTFTLoss(window_lengths=(512, 128))),
    "mel": (trecon.MelSpectrogramLoss(n_mels=(40, 10), window_lengths=(512, 64),
                                      mel_fmin=(0, 0), mel_fmax=(None, None),
                                      pow=1.0, mag_weight=0.0),
            jrecon.MelSpectrogramLoss(n_mels=(40, 10), window_lengths=(512, 64),
                                      mel_fmin=(0, 0), mel_fmax=(None, None),
                                      pow=1.0, mag_weight=0.0)),
    "mel_mag": (trecon.MelSpectrogramLoss(n_mels=(20,), window_lengths=(256,),
                                          mel_fmin=(0,), mel_fmax=(None,)),
                jrecon.MelSpectrogramLoss(n_mels=(20,), window_lengths=(256,),
                                          mel_fmin=(0,), mel_fmax=(None,))),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss_value_and_grad_match_jax(name):
    tloss, jloss = LOSSES[name]
    x, y = _audio(3), _audio(4)
    y[..., :400] = 0.0  # silent frames: zero STFT bins, the clamps' branch
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tloss(xt, torch.from_numpy(y))
    got.backward()
    want, jgrad = jax.value_and_grad(lambda a: jloss(a, jnp.asarray(y)))(
        jnp.asarray(x))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert np.isfinite(xt.grad.numpy()).all()
    _close(xt.grad.numpy(), jgrad, rtol=1e-4, scale_atol=1e-4)


def test_mel_loss_levels_branch_matches_jax():
    tloss, jloss = LOSSES["mel"]
    x, y = _audio(5), _audio(6)
    levels = np.array([0.5, 3.0], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tloss(xt, torch.from_numpy(y), levels=torch.from_numpy(levels))
    got.backward()
    want, jgrad = jax.value_and_grad(
        lambda a: jloss(a, jnp.asarray(y), levels=jnp.asarray(levels)))(
        jnp.asarray(x))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    _close(xt.grad.numpy(), jgrad, rtol=1e-4, scale_atol=1e-4)


def _fmaps(seed):
    """Two sub-discriminators' feature maps, three maps each (logits last),
    as numpy arrays."""
    rng = np.random.RandomState(seed)
    return [[rng.randn(2, 4, 6, 3).astype(np.float32) for _ in range(3)]
            for _ in range(2)]


def test_gan_losses_match_jax():
    fake, real = _fmaps(7), _fmaps(8)
    tf = [[torch.from_numpy(m).requires_grad_(True) for m in d] for d in fake]
    tr = [[torch.from_numpy(m).requires_grad_(True) for m in d] for d in real]
    jf = [[jnp.asarray(m) for m in d] for d in fake]
    jr = [[jnp.asarray(m) for m in d] for d in real]
    np.testing.assert_allclose(tgan.discriminator_loss(tf, tr).item(),
                               float(jgan.discriminator_loss(jf, jr)), rtol=1e-6)
    g, feat = tgan.generator_loss(tf, tr)
    jg, jfeat = jgan.generator_loss(jf, jr)
    np.testing.assert_allclose(g.item(), float(jg), rtol=1e-6)
    np.testing.assert_allclose(feat.item(), float(jfeat), rtol=1e-6)
    # the real maps are detached in the feature-matching term, as in JAX
    (g + feat).backward()
    assert all(m.grad is None for d in tr for m in d)
    jgrads = jax.grad(lambda f: sum(jgan.generator_loss(f, jr)))(jf)
    for td, jd in zip(tf, jgrads):
        for tm, jm in zip(td, jd):
            _close(tm.grad.numpy(), jm, rtol=1e-5)
