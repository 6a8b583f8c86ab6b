"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA card they skip (a CUDA kernel has no
interpret mode). Run them on the card with
``python -m pytest tests/test_torch_cuda.py -q``. Tolerances: Snake within
1e-6; fused RVQ codes identical off near-ties (top-2 margin > 1e-5) and z_q
within 1e-4 on the frames whose codes agree.
"""

import numpy as np
import pytest
import torch

import vrvq_tpu_torch as port
from vrvq_tpu_torch.kernels import LAUNCHES
from vrvq_tpu_torch.ops import rvq_kernel, snake

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    port.disable_tf32()
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(1, 8, 1), (2, 7, 333), (3, 64, 4097)])
def test_snake_kernel_matches_plain(cuda, shape):
    gen = torch.Generator().manual_seed(shape[2])
    x = (4.0 * torch.randn(shape, generator=gen)).to(cuda)
    alpha = (0.1 + 2.0 * torch.rand(shape[1], generator=gen)).to(cuda)
    before = LAUNCHES["snake"]
    y = snake.snake(x, alpha)
    assert LAUNCHES["snake"] == before + 1
    torch.testing.assert_close(y, snake.snake_reference(x, alpha),
                               rtol=1e-6, atol=1e-6)


def test_snake_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(1, 4, 16, device=cuda)
    with pytest.raises(TypeError):
        snake.snake(x.double(), torch.ones(4, device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError):
        snake.snake(x.transpose(1, 2), torch.ones(16, device=cuda))


@pytest.mark.parametrize("d,frames,masked", [(8, 37, True), (8, 300, False),
                                             (4, 101, True)])
def test_fused_rvq_kernel_matches_plain(cuda, d, frames, masked):
    gen = torch.Generator().manual_seed(frames)
    nq, dim, k = 4, 256, 128
    w = rvq_kernel.RVQWeights(
        (torch.rand(nq, dim, d, generator=gen) - 0.5).to(cuda),
        (0.1 * torch.randn(nq, d, generator=gen)).to(cuda),
        (torch.rand(nq, d, dim, generator=gen) - 0.5).to(cuda),
        (0.1 * torch.randn(nq, dim, generator=gen)).to(cuda),
        torch.randn(nq, k, d, generator=gen).to(cuda),
    )
    z = torch.randn(frames, dim, generator=gen).to(cuda)
    mask = ((torch.rand(frames, nq, generator=gen) > 0.5).float().to(cuda)
            if masked else None)
    zq, codes = rvq_kernel.fused_rvq(z, *w, mask)
    rzq, rcodes = rvq_kernel.fused_rvq_reference(z, *w, mask)
    near_tie = rvq_kernel.reference_margins(z, *w) <= 1e-5
    agree = (codes == rcodes).all(dim=1)
    assert not (~agree & ~near_tie).any()
    torch.testing.assert_close(zq[agree], rzq[agree], rtol=0, atol=1e-4)


def test_small_model_kernel_path_matches_plain_path(cuda):
    """The small codec on the card: the kernel path (Snake kernel, fused RVQ)
    against the plain path (plain Snake, module quantizer) on the same
    convolutions. The Snake kernel rounds as its plain version does, so the
    importance map and the counts are identical; codes may differ only where
    a near-tie flips the argmax (and the residual of that frame's later
    stages with it)."""
    model = port.build_model(port.small_config(), device=cuda, seed=1)
    plain = model.clone(padding=True).use_kernels(False)
    x = np.random.RandomState(0).randn(44100).astype(np.float32) * 0.2
    sig = port.Signal(x, 44100)
    kernel_path = port.CodecProcessor(model, fused_quantizer=True).compress(
        sig, win_duration=0.5, level=1.0)
    plain_path = port.CodecProcessor(plain, fused_quantizer=False).compress(
        sig, win_duration=0.5, level=1.0)
    np.testing.assert_array_equal(kernel_path.vbr_counts, plain_path.vbr_counts)
    assert (kernel_path.codes != plain_path.codes).mean() < 0.01
