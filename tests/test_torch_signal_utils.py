"""The port's ``Signal`` spectral views against the JAX package's
(``vrvq_tpu/audio.py``), and ``utils.profile_trace``.

Spectral views within the tolerances of ``test_torch_train_losses.py``: rtol
1e-5 with an atol of 1e-5 of the largest magnitude; the log magnitude
mapped back to the (clamped) magnitude, ``10 ** (dB / 20)``, the same (a bin
far under the spectrum's scale has no relative accuracy in dB). Inputs are
seeded numpy arrays handed to both packages.
"""

import numpy as np
import pytest
import torch

from vrvq_tpu.audio import Signal as JaxSignal
from vrvq_tpu.audio import STFTParams as JaxSTFTParams
from vrvq_tpu_torch import utils as tutils
from vrvq_tpu_torch.audio import Signal, STFTParams

torch.set_num_threads(1)


def _close(got, want, rtol=1e-5, scale_atol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=scale_atol * float(np.max(np.abs(want))))


def _pair(sr=44100, params=None, seed=0):
    x = (0.3 * np.random.RandomState(seed).randn(2, 1, 6000)).astype(np.float32)
    jp = None if params is None else JaxSTFTParams(**params)
    tp = None if params is None else STFTParams(**params)
    return JaxSignal(x, sr, jp), Signal(x, sr, tp)


@pytest.mark.parametrize("sr", [44100, 16000])
def test_default_stft_params_and_numpy(sr):
    js, ts = _pair(sr)
    assert ts.stft_params.__dict__ == js.stft_params.__dict__
    np.testing.assert_array_equal(ts.numpy(), js.numpy())
    assert ts.clone().stft_params == ts.stft_params


@pytest.mark.parametrize("params", [None, dict(window_length=512, hop_length=128,
                                               match_stride=True, window_type="sqrt_hann")],
                         ids=["default", "match_stride"])
def test_spectral_views_match_jax(params):
    js, ts = _pair(params=params, seed=1)
    _close(ts.stft().numpy(), np.asarray(js.stft()))
    assert ts.stft_data is not None
    _close(ts.magnitude.numpy(), np.asarray(js.magnitude))
    # the log magnitude maps back to the clamped magnitude, held as it is
    _close(10 ** (ts.log_magnitude().numpy() / 20),
           10 ** (np.asarray(js.log_magnitude()) / 20))
    _close(ts.mel_spectrogram(40).numpy(), np.asarray(js.mel_spectrogram(40)))
    _close(ts.mel_spectrogram(20, mel_fmax=8000.0, window_length=1024,
                              hop_length=256).numpy(),
           np.asarray(js.mel_spectrogram(20, mel_fmax=8000.0, window_length=1024,
                                         hop_length=256)))
    # an STFT with other settings than the signal's
    _close(ts.stft(window_length=256, hop_length=64).numpy(),
           np.asarray(js.stft(window_length=256, hop_length=64)))


def test_annotate_and_profile_trace_write_a_trace(tmp_path):
    """``annotate``'s region shows in the trace ``profile_trace`` writes to
    its log directory."""
    with tutils.profile_trace(str(tmp_path)) as prof:
        with tutils.annotate("packed_region"):
            torch.ones(8).sum()
    assert any(e.name == "vrvq.packed_region" for e in prof.events())
    assert list(tmp_path.rglob("*.json")), list(tmp_path.iterdir())
