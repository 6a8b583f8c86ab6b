"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA card they skip (a CUDA kernel has no
interpret mode). Run them on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py -q``. Tolerances:
Snake within 1e-6; fused RVQ codes identical off near-ties (top-2 margin
> 1e-5) and z_q within 1e-4 on the frames whose codes agree; exact ties
between equal codebook rows go to the lower index.

Besides the flagship's shapes, the edges of the two designs: Snake rows
whose T % 4 leaves a scalar head and tail, a base pointer off 16 bytes (a
contiguous view with a storage offset), several rows, T = 1 and 1024
channels; fused RVQ with equal codebook rows in two CTAs' slices, F = 1, F
off the tile of 4 frames, 1 and 2 stages (the double buffer never refilled),
28 stages at the flagship's width, d = 4, no mask, and clusters of 4, 2
and 1 CTAs (widths that 8 does not split into 16-byte slices).
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


@pytest.mark.parametrize("shape,offset", [
    ((1, 8, 4097), 0), ((1, 8, 4098), 0), ((1, 8, 4099), 0),
    ((2, 16, 333), 1), ((2, 16, 333), 2), ((1, 64, 44538), 3),
    ((3, 64, 4097), 0), ((2, 7, 1), 0), ((1, 1024, 74), 0),
], ids=["T%4=1", "T%4=2", "T%4=3", "offset1", "offset2", "offset3-serve",
        "B3", "T1", "C1024"])
def test_snake_kernel_edges(cuda, shape, offset):
    """``offset`` floats into a buffer: the view is contiguous, its base off
    16 bytes (and off y's alignment) when the offset is not a multiple of 4."""
    gen = torch.Generator().manual_seed(sum(shape) + offset)
    n = int(np.prod(shape))
    buf = (4.0 * torch.randn(n + offset, generator=gen)).to(cuda)
    x = buf[offset:].view(shape)
    assert x.is_contiguous() and x.storage_offset() == offset
    alpha = (0.1 + 2.0 * torch.rand(shape[1], generator=gen)).to(cuda)
    torch.testing.assert_close(snake.snake(x, alpha),
                               snake.snake_reference(x, alpha),
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


def _uniform_weights(gen, nq, dim, k, d, device):
    """Drawn as the codec's initialization draws them: projections uniform
    in +-1/sqrt(fan_in), codebooks N(0, 1), small biases."""
    return rvq_kernel.RVQWeights(
        ((2 * torch.rand(nq, dim, d, generator=gen) - 1) / dim ** 0.5).to(device),
        (0.1 * torch.randn(nq, d, generator=gen)).to(device),
        ((2 * torch.rand(nq, d, dim, generator=gen) - 1) / d ** 0.5).to(device),
        (0.1 * torch.randn(nq, dim, generator=gen)).to(device),
        torch.randn(nq, k, d, generator=gen).to(device),
    )


def _assert_matches_plain(z, w, mask, zq, codes):
    rzq, rcodes = rvq_kernel.fused_rvq_reference(z, *w, mask)
    near_tie = rvq_kernel.reference_margins(z, *w) <= 1e-5
    agree = (codes == rcodes).all(dim=1)
    assert not (~agree & ~near_tie).any()
    torch.testing.assert_close(zq[agree], rzq[agree], rtol=0, atol=1e-4)


@pytest.mark.parametrize("nq,dim,k,d,frames,masked", [
    (4, 256, 128, 8, 1, True), (8, 1024, 1024, 8, 1, False),
    (8, 1024, 1024, 8, 37, True), (8, 1024, 1024, 8, 72, False),
    (28, 1024, 1024, 8, 72, True), (28, 1024, 1024, 8, 862, False),
    (8, 1024, 1024, 4, 100, True), (4, 256, 64, 4, 45, False),
    (1, 1024, 1024, 8, 101, True), (2, 1024, 1024, 8, 101, True),
    (4, 48, 64, 8, 37, True), (4, 40, 64, 4, 37, False),
    (4, 100, 64, 8, 37, True),
], ids=["F1-small", "F1", "F37", "F72-nomask", "Nq28-F72", "Nq28-F862",
        "d4", "d4-small-nomask", "Nq1-F101", "Nq2-F101", "cluster4",
        "cluster2-d4-nomask", "cluster1"])
def test_fused_rvq_kernel_edges(cuda, nq, dim, k, d, frames, masked):
    gen = torch.Generator().manual_seed(nq * frames + d)
    w = _uniform_weights(gen, nq, dim, k, d, cuda)
    z = torch.randn(frames, dim, generator=gen).to(cuda)
    mask = ((torch.rand(frames, nq, generator=gen) > 0.5).float().to(cuda)
            if masked else None)
    zq, codes = rvq_kernel.fused_rvq(z, *w, mask)
    _assert_matches_plain(z, w, mask, zq, codes)


@pytest.mark.parametrize("dim,k", [(1024, 1024), (256, 128)])
def test_fused_rvq_kernel_ties_take_the_lower_index(cuda, dim, k):
    """Rows 2 Kc + 3 and 5 Kc + 1 of every codebook are equal (two CTAs'
    slices) and e points at them: every frame's code is the lower one."""
    gen = torch.Generator().manual_seed(dim + k)
    nq, d = 4, 8
    w = _uniform_weights(gen, nq, dim, k, d, cuda)
    kc = k // rvq_kernel.cluster_size(dim, k)
    lo, hi = 2 * kc + 3, 5 * kc + 1
    w.cb[:, hi] = w.cb[:, lo]
    w.wi.mul_(1e-3)
    w.bi.copy_(10.0 * w.cb[:, lo])
    z = torch.randn(50, dim, generator=gen).to(cuda)
    zq, codes = rvq_kernel.fused_rvq(z, *w)
    rzq, rcodes = rvq_kernel.fused_rvq_reference(z, *w)
    assert (rcodes == lo).all()
    assert (codes == lo).all(), codes.unique()
    torch.testing.assert_close(zq, rzq, rtol=0, atol=1e-4)
