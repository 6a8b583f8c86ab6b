"""The committed flagship reference (``vrvq_tpu_torch/reference.py``) is what
the port computes on the CPU from the seed: the flagship drawn from seed 0,
the seeded 3 s clip through ``compress`` (VBR, level 1, 1 s windows) and
``decompress``. Codes and counts bit-identical (the same float32 arithmetic
on the same CPU code path), the first second of audio within 1e-5 (a
different thread count may reorder a conv's sums). The file stays under
200 KB."""

import numpy as np
import torch
import pytest

import vrvq_tpu_torch as port
from vrvq_tpu_torch import reference

torch.set_num_threads(1)  # as tests/test_torch_support.py sets it


@pytest.fixture(scope="module")
def fixture():
    return reference.load()


def test_reference_fixture_is_small_and_whole(fixture):
    assert reference.FIXTURE.stat().st_size < 200_000
    codes, counts = fixture["codes"], fixture["counts"]
    frames = int(np.ceil(reference.CLIP_S * 44100 / 512))
    assert codes.shape[:2] == (1, 8) and codes.shape[-1] >= frames
    assert counts.shape == (1, codes.shape[-1])
    assert fixture["audio"].shape == (int(reference.AUDIO_S * 44100),)
    assert fixture["audio"].dtype == np.float32
    assert codes.shape[-1] % int(fixture["chunk_length"]) == 0


def test_reference_fixture_matches_the_cpu(fixture):
    model = port.build_model(port.FLAGSHIP, device="cpu", seed=reference.SEED)
    out = reference.compute(model)
    np.testing.assert_array_equal(out["codes"], fixture["codes"])
    np.testing.assert_array_equal(out["counts"], fixture["counts"])
    assert out["dac"].chunk_length == int(fixture["chunk_length"])
    assert np.float32(out["dac"].input_db) == fixture["input_db"]
    np.testing.assert_allclose(out["audio"], fixture["audio"], rtol=0, atol=1e-5)
