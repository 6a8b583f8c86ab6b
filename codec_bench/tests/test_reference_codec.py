"""The plain reference codec against vrvq_tpu_torch at a small
configuration on the CPU, with the same seeded weights: the padded one
shot and the padding-free window give the same codes and kept stages, and
the same audio to float rounding."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from codec_bench import clips, judge, program, weights
from codec_bench.tests.helpers import TINY
from vrvq_tpu_torch.infer import fast
from vrvq_tpu_torch.infer.codec_api import CodecProcessor

KEYS = TINY["keys"]


@pytest.fixture(scope="module")
def pair():
    ref = judge.reference_codec(KEYS, 3, "cpu")
    model = program.codec(KEYS, weights.host_state(ref), "cpu")
    audio = clips.clips(2, 22050, 44100, weights.generator(3, "cpu", 1), "cpu")[:, None]
    return ref, model, F.pad(audio, (0, -audio.shape[-1] % ref.hop))


@pytest.mark.parametrize("level", [0.5, 1.0, 2.0])
def test_one_shot(pair, level):
    ref, model, audio = pair
    rc, rn = ref.encode(audio, level)
    with torch.inference_mode():
        enc = model.encode(audio, level=level)
        counts = enc["mask_imp"].sum(1)
        y = model.decode_from_codes(enc["codes"], enc["mask_imp"])
    assert np.array_equal(judge.code_mismatch(enc["codes"], counts, rc, rn), [0, 0])
    assert 0 < rn.float().mean() <= KEYS["DAC_VRVQ.n_codebooks"]
    ry = ref.decode(rc, rn)
    assert judge.rel_err(y, ry).max() < 1e-5


def test_fast_profile_codes(pair):
    ref, model, audio = pair
    rc, rn = ref.encode(audio, 1.0)
    with torch.inference_mode():
        fm = fast.make_inference_model(model)
        codes, mask = fast.encode_codes(fm, audio, 1.0)
        y = fm.decode_from_codes(codes.long(), mask)
    assert judge.code_mismatch(codes, mask.sum(1), rc, rn).max() == 0
    err = judge.rel_err(y, ref.decode(rc, rn)).max()
    assert 1e-5 < err < 0.05  # a bfloat16 decoder


def test_padding_free_window(pair):
    ref_pad, model, _ = pair
    ref = judge.reference_codec(KEYS, 3, "cpu", padding=False)
    proc = CodecProcessor(model, fused_quantizer=True)
    window, hop, frames, delay = proc.window_geometry(1.0)
    x = clips.clips(3, window, 44100, weights.generator(4, "cpu", 1), "cpu")[:, None]
    rc, rn = ref.encode(x, 1.0)
    with torch.inference_mode():
        codes, counts = proc.encode_rows(False, proc.put_batch(x.numpy()), None, 1.0,
                                         proc.prepared_rvq())
        mask = (torch.arange(codes.shape[1])[None, :, None] < counts[:, None, :]).float()
        y = proc.decode_rows(False, proc.put_batch(codes.long().numpy()),
                             proc.put_batch(mask.numpy()))
    assert rc.shape[-1] == frames
    assert judge.code_mismatch(codes, counts, rc, rn).max() == 0
    ry = ref.decode(rc, rn)
    assert ry.shape[-1] == hop
    assert judge.rel_err(y, ry).max() < 1e-5


def test_lower_precision_moves_audio(pair):
    ref, _, audio = pair
    rc, rn = ref.encode(audio, 1.0)
    exact = ref.decode(rc, rn)
    judge.emulate_fp8(ref.decoder, True)
    try:
        rough = ref.decode(rc, rn)
    finally:
        judge.emulate_fp8(ref.decoder, False)
    assert judge.rel_err(rough, exact).max() > 1e-2
