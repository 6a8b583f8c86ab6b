"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA card they skip (a CUDA kernel has no
interpret mode). Run them on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py -q``. Tolerances:
Snake within 1e-6 in float32 and bit-identical in bfloat16 (each mode
against its plain version, which rounds every step as the kernel does);
fused RVQ codes identical off near-ties (top-2 margin > 1e-5) and z_q within
1e-4 on the frames whose codes agree; exact ties between equal codebook rows
go to the lower index.

Besides the flagship's shapes, the edges of the two designs: Snake rows
whose T % 4 (T % 8 in bfloat16) leaves a scalar head and tail, a base
pointer off 16 bytes (a contiguous view with a storage offset), several rows,
T = 1 and 1024 channels, in all four modes (exact or polynomial sin^2,
float32 or bfloat16); fused RVQ with equal codebook rows in two CTAs' slices,
F = 1, F off the tile of 4 frames, 1 and 2 stages (the double buffer never
refilled), 28 stages at the flagship's width, no mask, clusters of 4, 2 and
1 CTAs (widths that 8 does not split into 16-byte slices), and every
codebook shape the JAX kernel takes: d in {1, 2, 3, 4, 8, 16, 32} against D
and K in {1024, 1000, 6} at F in {1, 72, 101} (d, D and K padded by the
packing), through the wrapper and through ``CodecProcessor``.
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


MODES = {"exact": (torch.float32, False), "approx": (torch.float32, True),
         "exact-bf16": (torch.bfloat16, False),
         "approx-bf16": (torch.bfloat16, True)}


def _assert_snake_matches_plain(x, alpha, approx):
    y = snake.snake(x, alpha, approx)
    ref = snake.snake_plain(x, alpha, approx)
    assert y.dtype == x.dtype
    if x.dtype == torch.bfloat16:
        assert torch.equal(y, ref), (y.float() - ref.float()).abs().max()
    else:
        torch.testing.assert_close(y, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shape", [(1, 8, 1), (2, 7, 333), (3, 64, 4097)])
def test_snake_kernel_matches_plain(cuda, shape, mode):
    dtype, approx = MODES[mode]
    gen = torch.Generator().manual_seed(shape[2])
    x = (4.0 * torch.randn(shape, generator=gen)).to(cuda, dtype)
    alpha = (0.1 + 2.0 * torch.rand(shape[1], generator=gen)).to(cuda)
    name = snake.mode_name(dtype, approx)
    before = LAUNCHES[name]
    _assert_snake_matches_plain(x, alpha, approx)
    assert LAUNCHES[name] == before + 1


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shape,offset", [
    ((1, 8, 4097), 0), ((1, 8, 4098), 0), ((1, 8, 4099), 0),
    ((2, 16, 333), 1), ((2, 16, 333), 2), ((1, 64, 44538), 3),
    ((3, 64, 4097), 0), ((2, 7, 1), 0), ((1, 1024, 74), 0),
    ((1, 8, 4101), 0), ((2, 16, 333), 5), ((2, 16, 333), 7),
], ids=["T%4=1", "T%4=2", "T%4=3", "offset1", "offset2", "offset3-serve",
        "B3", "T1", "C1024", "T%8=5", "offset5", "offset7"])
def test_snake_kernel_edges(cuda, shape, offset, mode):
    """``offset`` elements into a buffer: the view is contiguous, its base
    off 16 bytes (and off y's alignment) when the offset is not a multiple
    of 16 bytes."""
    dtype, approx = MODES[mode]
    gen = torch.Generator().manual_seed(sum(shape) + offset)
    n = int(np.prod(shape))
    buf = (4.0 * torch.randn(n + offset, generator=gen)).to(cuda, dtype)
    x = buf[offset:].view(shape)
    assert x.is_contiguous() and x.storage_offset() == offset
    alpha = (0.1 + 2.0 * torch.rand(shape[1], generator=gen)).to(cuda)
    _assert_snake_matches_plain(x, alpha, approx)


def test_snake_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(1, 4, 16, device=cuda)
    with pytest.raises(TypeError):
        snake.snake(x.double(), torch.ones(4, device=cuda, dtype=torch.float64))
    with pytest.raises(TypeError):
        snake.snake(x.half(), torch.ones(4, device=cuda), approx=True)
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


# every codebook shape the JAX kernel takes: each d against each (D, K), the
# frames cycling through 1, 72 (a 1 s window) and 101
SHAPE_CASES = [
    (4, dim, k, d, (1, 72, 101)[i % 3], i % 2 == 0)
    for i, (d, dim, k) in enumerate(
        (d, dim, k) for d in (1, 2, 3, 4, 8, 16, 32)
        for dim in (1024, 1000, 6) for k in (1024, 1000, 6))
]
SHAPE_IDS = [f"d{d}-D{dim}-K{k}-F{f}" for _, dim, k, d, f, _ in SHAPE_CASES]


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
    (4, 100, 64, 8, 37, True), (4, 1001, 1001, 8, 72, True),
    *SHAPE_CASES,
], ids=["F1-small", "F1", "F37", "F72-nomask", "Nq28-F72", "Nq28-F862",
        "d4", "d4-small-nomask", "Nq1-F101", "Nq2-F101", "cluster4",
        "cluster2-d4-nomask", "cluster1", "D1001-K1001-padded8",
        *SHAPE_IDS])
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


@pytest.mark.parametrize("overrides", [
    dict(codebook_dim=16), dict(codebook_dim=3), dict(codebook_size=1000),
    dict(codebook_dim=1, codebook_size=6)], ids=["d16", "d3", "K1000", "d1-K6"])
def test_codec_processor_serves_every_codebook_shape(cuda, overrides):
    """``CodecProcessor(fused_quantizer=True)`` on a codec whose codebooks
    the kernel pads: its codes equal the plain version's off near ties, on
    the same latents."""
    model = port.build_model(port.small_config(**overrides), device=cuda, seed=2)
    proc = port.CodecProcessor(model, fused_quantizer=True)
    x = np.random.RandomState(1).randn(1, 1, 8192).astype(np.float32) * 0.2
    with torch.inference_mode():
        audio = torch.from_numpy(x).to(cuda)
        rvq = rvq_kernel.prepare_rvq(
            rvq_kernel.stack_quantizer_weights(model.quantizer))
        before = LAUNCHES["rvq"]
        codes, _ = proc._encode(model, audio, None, 1.0, rvq)
        assert LAUNCHES["rvq"] == before + 1
        z = model.encoder(audio)
        frames = z.transpose(1, 2).reshape(-1, z.shape[1])
        _, ref = rvq_kernel.fused_rvq_reference(frames, *rvq.weights)
        near_tie = rvq_kernel.reference_margins(frames, *rvq.weights) <= 1e-5
    flipped = (codes[0].T != ref).any(dim=1)
    assert not (flipped & ~near_tie).any()
