"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without an NVIDIA card they skip (a CUDA kernel has no
interpret mode). Run them on the card with
``python -m pytest --noconftest tests/test_torch_cuda.py -q``. Tolerances:
Snake within 1e-6 in float32 and bit-identical in bfloat16 (each mode
against its plain version, which rounds every step as the kernel does);
fused RVQ codes identical off near-ties (top-2 margin > 1e-5) and z_q within
1e-4 on the frames whose codes agree; exact ties between equal codebook rows
go to the lower index.

K2's channels-last mode (the bfloat16 decoder's layout) at every Snake
shape of the fast decoder at 16 x 10 s and at odd channel counts, ragged
vectors and offsets, bit-identical to the plain version; the convs that
decoder hands cuDNN in another form (``nn/layers.conv_last``: phases,
widened) within one bfloat16 rounding of the plain conv; the fast decoder
on the card taking that path, within 50 dB of its (B, C, T) computation.

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

The training path: Snake's backward kernel in both float32 modes (exact,
and the polynomial of ``vrvq_a2_fast.yml``) against its plain version at
every shape of the flagship train step's census and at edge shapes (dx
bit-identical, dalpha within 1e-4 of its largest element, two launches
bit-identical); a grad-requiring Snake on the card has a ``grad_fn`` and
plain autograd's gradients; the bfloat16 modes and K1 raise under grad; one
train step at the flagship width reaches every parameter. The CBR codec and
a 28-stage codec serve through K1 as the plain path does.

The model surface: K2's exact bfloat16 mode at every shape of the
bfloat16-encoder profile and K1 on that profile's latents; ``DAC_MOE``'s
kernel path against its plain path; the fused quantizer refusing mixed
codebook widths.

The trainer's edge: the native I/O library built on the card's machine
(wav reader, loudness meter and range coder, its counters rising), and
``train()`` with MSD and ``save_samples`` on the card by default.

The synthetic corpus, ``cli.train`` and ``cli.measure_trained`` on the card
by default, with K1 and K2 launched.

Bit-exact training: a small step built twice from its seed under
``torch.use_deterministic_algorithms(True)`` (nothing raises) and once
without it gives the same bits each time, and a run resumed from ``latest``
the bits of the straight run.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import vrvq_tpu_torch as port
from vrvq_tpu_torch.kernels import LAUNCHES
from vrvq_tpu_torch.ops import rvq_kernel, snake
from layout_twin import ncl_twin

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
    """Types and layouts no kernel takes raise. A transposed contiguous
    tensor is the channels-last layout, which its own kernel takes."""
    x = torch.randn(2, 4, 16, device=cuda)
    with pytest.raises(TypeError):
        snake.snake(x.double(), torch.ones(4, device=cuda, dtype=torch.float64))
    with pytest.raises(TypeError):
        snake.snake(x.half(), torch.ones(4, device=cuda), approx=True)
    last = x.transpose(1, 2).contiguous().transpose(1, 2)
    for other in (x[..., ::2], last[..., 1:-1], x.transpose(0, 1)):
        with pytest.raises(ValueError, match="contiguous or channels-last"):
            snake.snake(other, torch.ones(other.shape[1], device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        snake.snake_backward(last, torch.ones(4, device=cuda), torch.ones_like(last))
    before = LAUNCHES["snake_cl"]
    _assert_snake_matches_plain(x.transpose(1, 2), torch.ones(16, device=cuda), False)
    assert LAUNCHES["snake_cl"] == before + 1


# the fast profile's bfloat16 decoder at 16 x 10 s: its Snakes' shapes
FAST_DECODER_CENSUS = [(16, 1536, 862), (16, 768, 6896), (16, 384, 55168),
                       (16, 192, 220672), (16, 96, 441344)]


def _channels_last_buffer(shape, offset, dtype, device, gen):
    """(B, C, T) values in channels-last memory, ``offset`` elements into
    their buffer."""
    b, c, t = shape
    buf = (4.0 * torch.randn(b * t * c + offset, generator=gen)).to(device, dtype)
    x = buf[offset:].view(b, t, c).transpose(1, 2)
    assert x.storage_offset() == offset
    return x


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shape,offset", [(s, 0) for s in FAST_DECODER_CENSUS] + [
    ((2, 7, 1001), 0), ((3, 13, 257), 1), ((3, 13, 257), 3), ((4, 96, 33), 8),
    ((4, 96, 33), 5), ((2, 12, 100), 4), ((1, 6, 4099), 0), ((2, 6200, 9), 0),
    ((2, 6200, 9), 1), ((5, 3, 2), 0),
], ids=[f"census{i}" for i in range(5)] + [
    "C7", "C13-offset1", "C13-offset3", "C96-offset8", "C96-offset5",
    "C12-offset4", "C6", "C6200", "C6200-offset1", "tiny"])
def test_snake_channels_last_matches_plain(cuda, shape, offset, mode):
    """K2's channels-last mode against the plain version (bit-identical in
    bfloat16) at every Snake shape of the fast decoder at 16 x 10 s, and at
    the edges of its design: channel counts off the 16-byte vector (odd, 12
    in bfloat16), a base off 16 bytes (and off y's alignment), more
    channels than its shared-memory table holds. The output keeps the
    layout, and the mode counts its own launches."""
    dtype, approx = MODES[mode]
    gen = torch.Generator().manual_seed(sum(shape) + offset)
    x = _channels_last_buffer(shape, offset, dtype, cuda, gen)
    assert snake.is_channels_last(x)
    alpha = (0.1 + 2.0 * torch.rand(shape[1], generator=gen)).to(cuda)
    name = snake.mode_name(dtype, approx, True)
    before = LAUNCHES[name]
    with torch.inference_mode():
        y = snake.snake(x, alpha, approx)
        assert y.stride() == x.stride()
        _assert_snake_matches_plain(x, alpha, approx)
    assert LAUNCHES[name] == before + 2


# the convs of the fast decoder at 16 x 10 s that cuDNN gets in another form
# (input, kernel, dilation, padding): its dilation-9 convs and the out conv
CONV_RESHAPED = [((16, 768, 6896), (768, 768, 7), 9, 27),
                 ((16, 384, 55168), (384, 384, 7), 9, 27),
                 ((16, 192, 220672), (192, 192, 7), 9, 27),
                 ((16, 96, 441344), (96, 96, 7), 9, 27),
                 ((16, 96, 441344), (1, 96, 7), 1, 3)]


@pytest.mark.parametrize("x_shape,w_shape,dilation,padding", CONV_RESHAPED + [
    ((2, 768, 80), (768, 768, 7), 9, 0), ((2, 16, 100), (5, 16, 7), 11, 0),
    ((3, 48, 300), (20, 48, 3), 5, 5), ((1, 96, 1000), (1, 96, 7), 1, 3),
    ((2, 32, 129), (130, 32, 7), 4, 12), ((2, 64, 900), (64, 64, 7), 9, 27)],
    ids=[f"decoder{i}" for i in range(5)] + [
        "padless", "C16-dil11", "C48-k3", "out-T1000", "N130", "T-multiple"])
def test_channels_last_conv_matches_plain(cuda, x_shape, w_shape, dilation, padding):
    """``nn/layers.conv_last`` against the plain conv (float32 sums rounded
    to bfloat16 once) at every shape of the fast decoder that cuDNN gets in
    another form (``conv_form``: phases, widened) and at edges (no padding,
    widths off 16, few frames, frames that the dilation divides): each
    output within one bfloat16 rounding of the plain one (the float32 sums
    run in another order), in channels-last memory."""
    from vrvq_tpu_torch.nn.layers import conv_last, to_channels_last

    gen = torch.Generator(device=cuda).manual_seed(sum(x_shape) + dilation)
    x = to_channels_last(torch.randn(x_shape, generator=gen, device=cuda).bfloat16())
    w = to_channels_last((0.05 * torch.randn(w_shape, generator=gen, device=cuda)).bfloat16())
    with torch.inference_mode():
        got = conv_last(x, w, 1, padding, dilation)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            want = F.conv1d(x.float(), w.float(), None, 1, padding,
                            dilation).bfloat16()
    assert got.shape == want.shape and got.stride(1) == 1
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                               atol=1e-5 * want.float().abs().max().item())


def test_fast_decoder_runs_channels_last_on_the_card(cuda):
    """The fast profile's decoder on the card: the channels-last path (its
    counter, K2's channels-last mode, no (B, C, T) Snake), within 50 dB of
    the same parameters computed in (B, C, T) (where it reads about 55: the
    convs' sums run in another order); the float32 codec launches no
    channels-last kernel."""
    from vrvq_tpu_torch.infer import fast
    from vrvq_tpu_torch.utils import counter

    model = port.build_model(port.small_config(), device=cuda, seed=0)
    m = fast.make_inference_model(model)
    twin = ncl_twin(m)
    x = torch.from_numpy(port.synthetic_clip(1.0, 44100, 7)[..., :44032]).to(cuda)
    with torch.inference_mode():
        codes, mask = fast.encode_codes(m, x, 1.0)
        LAUNCHES.clear()
        counter("decoder").clear()
        got = m.decode_from_codes(codes.long(), mask)
        torch.cuda.synchronize()
        assert dict(counter("decoder")) == {"channels_last": 1}
        assert LAUNCHES["snake_approx_bf16_cl"] > 0 and LAUNCHES["snake_approx_bf16"] == 0
        want = twin.decode_from_codes(codes.long(), mask)
        LAUNCHES.clear()
        model(x, level=1.0)
        torch.cuda.synchronize()
    assert not any(k.endswith("_cl") for k in LAUNCHES), dict(LAUNCHES)
    err = ((got - want).double() ** 2).sum() / (want.double() ** 2).sum()
    assert 10 * torch.log10(err).item() <= -50.0


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


# ------------------------------------------------------------ training path
# K2's backward: the shapes of the flagship train step's Snake census (batch
# 16 x 0.38 s), and edges: T = 1, short and odd rows, rows over one tile,
# more tiles than a row of the census, a base pointer off 16 bytes
SNAKE_TRAIN_CENSUS = [
    (16, 8, 33), (16, 32, 33), (16, 64, 16896), (16, 96, 16896), (16, 128, 33),
    (16, 128, 8448), (16, 192, 8448), (16, 256, 2112), (16, 384, 2112),
    (16, 512, 33), (16, 512, 264), (16, 768, 264), (16, 1024, 33),
    (16, 1536, 33)]
SNAKE_BWD_EDGES = [(1, 1, 1), (2, 3, 5), (3, 7, 2049), (1, 5, 4097),
                   (2, 64, 70001), (1, 2, 300000)]


def _snake_bwd_inputs(shape, device, offset=0):
    gen = torch.Generator().manual_seed(sum(shape) + offset)
    n = int(np.prod(shape))
    x = (3.0 * torch.randn(n + offset, generator=gen)).to(device)[offset:].view(shape)
    alpha = (0.5 + torch.rand(shape[1], generator=gen)).to(device)
    g = torch.randn(shape, generator=gen).to(device)
    return x, alpha, g


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset"])
@pytest.mark.parametrize("shape", SNAKE_TRAIN_CENSUS + SNAKE_BWD_EDGES)
def test_snake_backward_matches_plain_and_repeats_its_bits(cuda, shape, offset):
    """dx bit-identical to the plain version (the same roundings), dalpha
    within 1e-4 of max|dalpha| (a float32 sum in another order), and two
    launches bit-identical (no atomics)."""
    x, alpha, g = _snake_bwd_inputs(shape, cuda, offset)
    before = LAUNCHES["snake_backward"]
    dx, da = snake.snake_backward(x, alpha, g)
    dx2, da2 = snake.snake_backward(x, alpha, g)
    torch.cuda.synchronize()
    assert LAUNCHES["snake_backward"] == before + 2
    rdx, rda = snake.snake_backward_reference(x, alpha, g)
    assert torch.equal(dx, rdx), (dx - rdx).abs().max()
    assert (da - rda).abs().max() <= 1e-4 * rda.abs().max()
    assert torch.equal(dx, dx2) and torch.equal(da, da2)


# the polynomial mode's backward: the census and three odd shapes
SNAKE_APPROX_ODD = [(1, 1, 1), (3, 7, 2049), (2, 64, 70001)]


@pytest.mark.parametrize("shape", SNAKE_TRAIN_CENSUS + SNAKE_APPROX_ODD)
def test_snake_approx_backward_matches_plain_and_repeats_its_bits(cuda, shape):
    """The polynomial mode: dx bit-identical to
    ``snake_approx_backward_reference``, dalpha within 1e-4 of max|dalpha|,
    two launches bit-identical."""
    x, alpha, g = _snake_bwd_inputs(shape, cuda)
    x = 4.0 * x  # |alpha x| past 20: many periods of the reduction
    before = LAUNCHES["snake_approx_backward"]
    dx, da = snake.snake_backward(x, alpha, g, approx=True)
    dx2, da2 = snake.snake_backward(x, alpha, g, approx=True)
    torch.cuda.synchronize()
    assert LAUNCHES["snake_approx_backward"] == before + 2
    rdx, rda = snake.snake_approx_backward_reference(x, alpha, g)
    assert torch.equal(dx, rdx), (dx - rdx).abs().max()
    assert (da - rda).abs().max() <= 1e-4 * rda.abs().max()
    assert torch.equal(dx, dx2) and torch.equal(da, da2)


def test_polynomial_snake_on_the_card_has_a_gradient(cuda):
    """A grad-requiring polynomial call goes through SnakeFunction, and its
    gradients equal plain autograd's through the polynomial within 1e-5."""
    x, alpha, g = _snake_bwd_inputs((2, 48, 1000), cuda)
    xk, ak = x.clone().requires_grad_(True), alpha.clone().requires_grad_(True)
    y = snake.snake(xk, ak, approx=True)
    assert type(y.grad_fn).__name__ == "SnakeFunctionBackward"
    (y * g).sum().backward()
    xp, ap = x.clone().requires_grad_(True), alpha.clone().requires_grad_(True)
    (snake.snake_plain(xp, ap, approx=True) * g).sum().backward()
    torch.testing.assert_close(xk.grad, xp.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ak.grad, ap.grad, rtol=1e-4,
                               atol=1e-4 * float(ap.grad.abs().max()))


@pytest.mark.parametrize("overrides", [
    dict(model_type="CBR", quantizer_dropout=0.5), dict(n_codebooks=28)],
    ids=["cbr", "28-stages"])
def test_serve_path_kernels_match_plain_path(cuda, overrides):
    """The CBR codec (at 4 and 2 stages) and a 28-stage VBR codec (the
    24 kbps config's stage count) through ``CodecProcessor`` in 0.5 s
    windows: K1 on the card against the plain path, codes equal but for
    near-tie flips (under 1 %), VBR counts identical."""
    model = port.build_model(port.small_config(**overrides), device=cuda, seed=3)
    plain = model.clone(padding=True).use_kernels(False)
    sig = port.Signal(np.random.RandomState(4).randn(44100).astype(np.float32) * 0.2,
                      44100)
    requests = ([dict(n_quantizers=4), dict(n_quantizers=2)]
                if overrides.get("model_type") == "CBR" else [dict(level=1.0)])
    for req in requests:
        before = LAUNCHES["rvq"]
        kernel_path = port.CodecProcessor(model, fused_quantizer=True).compress(
            sig, win_duration=0.5, **req)
        assert LAUNCHES["rvq"] > before
        plain_path = port.CodecProcessor(plain, fused_quantizer=False).compress(
            sig, win_duration=0.5, **req)
        assert kernel_path.codes.shape == plain_path.codes.shape
        assert (kernel_path.codes != plain_path.codes).mean() < 0.01
        if "level" in req:
            np.testing.assert_array_equal(kernel_path.vbr_counts,
                                          plain_path.vbr_counts)


def test_snake_on_the_card_has_a_gradient(cuda):
    """A grad-requiring call goes through SnakeFunction: the result has a
    grad_fn, and the gradients equal plain autograd's within 1e-5."""
    x, alpha, g = _snake_bwd_inputs((2, 48, 1000), cuda)
    xk, ak = x.clone().requires_grad_(True), alpha.clone().requires_grad_(True)
    y = snake.snake(xk, ak)
    assert type(y.grad_fn).__name__ == "SnakeFunctionBackward"
    (y * g).sum().backward()
    xp, ap = x.clone().requires_grad_(True), alpha.clone().requires_grad_(True)
    (snake.snake_plain(xp, ap) * g).sum().backward()
    torch.testing.assert_close(xk.grad, xp.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ak.grad, ap.grad, rtol=1e-4,
                               atol=1e-4 * float(ap.grad.abs().max()))
    with torch.no_grad():
        assert snake.snake(xk, ak).grad_fn is None


@pytest.mark.parametrize("mode", ["exact-bf16", "approx-bf16"])
def test_snake_modes_without_backward_raise_on_the_card(cuda, mode):
    dtype, approx = MODES[mode]
    x = torch.randn(1, 4, 64, device=cuda).to(dtype)
    alpha = torch.ones(4, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        snake.snake(x, alpha, approx)


def test_fused_rvq_raises_under_grad_on_the_card(cuda):
    model = port.build_model(port.small_config(), device=cuda)
    w = rvq_kernel.stack_quantizer_weights(model.quantizer)  # requires grad
    z = torch.randn(8, w.wi.shape[1], device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        rvq_kernel.fused_rvq(z, *w)


def test_flagship_train_step_reaches_every_parameter(cuda):
    """One train step at the flagship width (batch 4 x 0.38 s): every
    parameter of the generator and of the discriminator gets a non-zero
    gradient, K2's backward runs once per Snake, K1 never."""
    from vrvq_tpu_torch.config import FLAGSHIP_YAML, REPO, Config
    from vrvq_tpu_torch.losses import L1Loss, MelSpectrogramLoss, MultiScaleSTFTLoss
    from vrvq_tpu_torch.models.discriminator import Discriminator
    from vrvq_tpu_torch.train import loop, trainer
    from vrvq_tpu_torch.train.state import TrainState, make_optimizer

    cfg = Config.load(FLAGSHIP_YAML, base_dir=REPO)
    draw = torch.Generator().manual_seed(0)
    gen = port.init_params(port.DAC_VRVQ(port.FLAGSHIP), draw).to(cuda)
    disc = port.init_params(Discriminator(**cfg.kwargs("Discriminator")),
                            draw).to(cuda)
    state = TrainState(gen, disc, make_optimizer(gen.parameters(), max_grad_norm=1e3),
                       make_optimizer(disc.parameters(), max_grad_norm=10.0))
    step = loop.make_train_step(
        cfg["lambdas"], MultiScaleSTFTLoss(**cfg.kwargs("MultiScaleSTFTLoss")),
        MelSpectrogramLoss(**cfg.kwargs("MelSpectrogramLoss")), L1Loss())
    audio = torch.from_numpy(np.concatenate(
        [port.synthetic_clip(0.38, 44100, s) for s in range(4)])).to(cuda)
    LAUNCHES.clear()
    metrics = step(state, audio, generator=trainer.step_generator(0, 0, cuda))
    torch.cuda.synchronize()
    assert all(torch.isfinite(v) for v in metrics.values())
    assert LAUNCHES["snake_backward"] == LAUNCHES["snake"] == 64, dict(LAUNCHES)
    assert LAUNCHES["rvq"] == 0
    for net in (gen, disc):
        for name, p in net.named_parameters():
            assert p.grad is not None and torch.count_nonzero(p.grad) > 0, name


def _bf16_encoder_census(cuda):
    """The (mode, shape) -> launches of the flagship's bfloat16-encoder
    profile over one 1 s padding-free window and one padded 1 s clip, and
    the profile."""
    from vrvq_tpu_torch import kernel_times as kt
    from vrvq_tpu_torch.infer import fast

    model = port.build_model(port.FLAGSHIP, device=cuda, seed=0)
    bf16 = fast.make_inference_model(model, encode_dtype=torch.bfloat16)
    window = port.CodecProcessor(bf16).window_geometry(1.0)[0]
    x = torch.from_numpy(port.synthetic_clip(1.5, 44100, 2)).to(cuda)
    with torch.inference_mode(), kt.snake_census(bf16.encoder, by_mode=True) as census:
        bf16.clone(padding=False).encoder(x[..., :window])
        bf16.encoder(x[..., :44032])
    return census, bf16


def test_snake_bf16_at_every_bf16_encoder_shape(cuda):
    """K2's exact bfloat16 mode bit-identical to its plain version at every
    shape the bfloat16 encoder gives it (channels 64 to 1024)."""
    census, _ = _bf16_encoder_census(cuda)
    shapes = sorted(s for m, s in census if m == "snake_bf16")
    assert {m for m, _ in census} == {"snake_bf16"}
    assert {s[1] for s in shapes} == {64, 128, 256, 512, 1024}
    gen = torch.Generator().manual_seed(0)
    for shape in shapes:
        x = (3.0 * torch.randn(shape, generator=gen)).to(cuda, torch.bfloat16)
        alpha = (0.5 + torch.rand(shape[1], generator=gen)).to(cuda)
        with torch.inference_mode():
            _assert_snake_matches_plain(x, alpha, approx=False)


def test_fused_rvq_on_bf16_latents_matches_plain(cuda):
    """K1 on the bfloat16 encoder's float32 latents: the plain quantizer's
    codes off near ties."""
    _, bf16 = _bf16_encoder_census(cuda)
    x = torch.from_numpy(port.synthetic_clip(1.0, 44100, 3)).to(cuda)
    with torch.inference_mode():
        z = bf16.encoder(x[..., :44032])
        assert z.dtype == torch.float32
        frames = z.transpose(1, 2).reshape(-1, z.shape[1]).contiguous()
        w = rvq_kernel.stack_quantizer_weights(bf16.quantizer)
        zq, codes = rvq_kernel.fused_rvq(frames, *w)
        _assert_matches_plain(frames, w, None, zq, codes)


def test_moe_kernel_path_matches_plain_path(cuda):
    """A small DAC_MOE on the card: encode at three levels with the Snake
    kernel against the plain Snake (masks equal, codes equal off near
    ties), ``decode_from_codes`` within 1e-4, CBR serving through
    ``CodecProcessor`` as the plain path serves; its VBR compress and the
    fused quantizer raise."""
    model = port.build_model(port.small_config(), device=cuda, seed=5,
                             model_class=port.DAC_MOE)
    plain = model.clone(padding=True).use_kernels(False)
    x = torch.from_numpy(np.random.RandomState(6).randn(2, 1, 16384)
                         .astype(np.float32) * 0.3).to(cuda)
    w = rvq_kernel.stack_quantizer_weights(model.quantizer)
    with torch.inference_mode():
        z = plain.encoder(x)
        near_tie = (rvq_kernel.reference_margins(
            z.transpose(1, 2).reshape(-1, z.shape[1]), *w) <= 1e-5).reshape(2, -1)
        before = LAUNCHES["snake"]
        for level in (0.5, 1.0, 2.0):
            got, want = model.encode(x, level=level), plain.encode(x, level=level)
            assert torch.equal(got["mask_imp"], want["mask_imp"])
            flipped = (got["codes"] != want["codes"]).any(dim=1)
            assert not (flipped & ~near_tie).any()
        assert LAUNCHES["snake"] > before
        a = model.decode_from_codes(got["codes"], got["mask_imp"])
        b = plain.decode_from_codes(got["codes"], got["mask_imp"])
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    sig = port.Signal(np.random.RandomState(4).randn(44100).astype(np.float32) * 0.2,
                      44100)
    kernel_path = port.CodecProcessor(model).compress(sig, win_duration=0.5,
                                                      n_quantizers=3)
    plain_path = port.CodecProcessor(plain).compress(sig, win_duration=0.5,
                                                     n_quantizers=3)
    assert (kernel_path.codes != plain_path.codes).mean() < 0.01
    with pytest.raises(NotImplementedError, match="prefix"):
        port.CodecProcessor(model).compress(sig, level=1.0)
    with pytest.raises(ValueError, match="DAC_VRVQ only"):
        port.CodecProcessor(model, fused_quantizer=True)


def test_fused_quantizer_raises_on_mixed_widths_on_the_card(cuda):
    model = port.build_model(port.small_config(codebook_dim=(8, 4, 4, 2)),
                             device=cuda, seed=1)
    with pytest.raises(ValueError, match=r"\[8, 4, 4, 2\]"):
        port.CodecProcessor(model, fused_quantizer=True)
    with pytest.raises(ValueError, match="one codebook width"):
        rvq_kernel.stack_quantizer_weights(model.quantizer)
    sig = port.Signal(port.synthetic_clip(1.0, 44100, 2), 44100)
    dac = port.CodecProcessor(model).compress(sig, win_duration=0.5, level=1.0)
    assert dac.codes.shape[1] == 4 and dac.vbr_counts is not None


# ------------------------------------------------------- several cards
def test_kernels_launch_on_the_last_card(cuda):
    """K2 (forward and backward, every mode) and K1 on a tensor of the last
    visible card, while the current card is the first: each launch goes to
    its tensor's card (K1 raises its shared-memory limit there too) and
    agrees with its plain version. Skips below 2 cards."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    last = torch.device("cuda", n - 1)
    torch.cuda.set_device(0)
    gen = torch.Generator().manual_seed(5)
    for dtype, approx in MODES.values():
        x = torch.randn((2, 64, 1031), generator=gen).to(last, dtype)
        alpha = (torch.rand(64, generator=gen) + 0.5).to(last)
        with torch.inference_mode():
            _assert_snake_matches_plain(x, alpha, approx)
    x = torch.randn((2, 64, 1031), generator=gen).to(last)
    alpha = (torch.rand(64, generator=gen) + 0.5).to(last)
    g = torch.randn((2, 64, 1031), generator=gen).to(last)
    dx, dalpha = snake.snake_backward(x, alpha, g)
    rx, ralpha = snake.snake_backward_reference(x, alpha, g)
    assert torch.equal(dx, rx)
    torch.testing.assert_close(dalpha, ralpha, rtol=1e-4, atol=1e-4 * ralpha.abs().max())
    model = port.build_model(port.FLAGSHIP, device=last, seed=0)
    z = torch.randn((1, 1024, 72), generator=gen).to(last)
    with torch.inference_mode():
        rvq = rvq_kernel.prepare_rvq(rvq_kernel.stack_quantizer_weights(model.quantizer))
        _, codes = rvq_kernel.quantize_fused(rvq, z)
        frames = z.transpose(1, 2).reshape(-1, 1024)
        _, ref = rvq_kernel.fused_rvq_reference(frames, *rvq.weights)
        near_tie = rvq_kernel.reference_margins(frames, *rvq.weights) <= 1e-5
    torch.cuda.synchronize(last)
    assert codes.device == last and torch.cuda.current_device() == 0
    assert not ((codes[0].T != ref).any(dim=1) & ~near_tie).any()


def test_codec_processor_on_card_0_equals_the_default(cuda):
    model = port.build_model(port.FLAGSHIP, device=cuda, seed=0)
    sig = port.Signal(port.synthetic_clip(2.5, 44100, 9), 44100)
    default = port.CodecProcessor(model, fused_quantizer=True)
    listed = port.CodecProcessor(model, fused_quantizer=True,
                                 devices=[torch.device("cuda", 0)])
    assert listed.replicas[0][0] is model
    a = default.compress(sig, win_duration=1.0, level=1.0)
    b = listed.compress(sig, win_duration=1.0, level=1.0)
    assert np.array_equal(a.codes, b.codes) and np.array_equal(a.vbr_counts, b.vbr_counts)
    assert np.array_equal(default.decompress(a).audio_data,
                          listed.decompress(b).audio_data)


def test_remat_step_on_the_card_equals_the_plain_step(cuda):
    """One step of a small codec (MPD 2, one MRD of 512) with ``remat``
    against the same step without, same parameters, batch and draws, on the
    card: losses within 1e-5 relative, the gradients the update took and
    the parameters within 1e-4 relative L2, each over both networks as one
    vector (two runs of one step on the card differ by cuDNN's order of
    sums, which moves a gradient of small norm, and Adam's first step is
    about lr x sign(g): a small tensor is not held alone); K2's forward runs
    again in the recompute."""
    from vrvq_tpu_torch.losses import L1Loss, MelSpectrogramLoss, MultiScaleSTFTLoss
    from vrvq_tpu_torch.models.discriminator import Discriminator
    from vrvq_tpu_torch.train import loop
    from vrvq_tpu_torch.train.state import TrainState, make_optimizer

    config = port.small_config(quantizer_dropout=0.25, full_codebook_rate=0.25,
                               level_min=0.125, level_max=6.0)
    draw = torch.Generator().manual_seed(0)
    gen_sd = port.init_params(port.DAC_VRVQ(config), draw).state_dict()
    disc_sd = port.init_params(Discriminator(periods=(2,), fft_sizes=(512,)),
                               draw).state_dict()
    audio = torch.from_numpy(np.concatenate(
        [port.synthetic_clip(0.2, 44100, s) for s in range(4)])).to(cuda)

    def step(remat):
        gen = port.DAC_VRVQ(config)
        gen.load_state_dict(gen_sd)
        disc = Discriminator(periods=(2,), fft_sizes=(512,))
        disc.load_state_dict(disc_sd)
        gen, disc = gen.to(cuda), disc.to(cuda)
        state = TrainState(gen, disc, make_optimizer(gen.parameters(), max_grad_norm=1e3),
                           make_optimizer(disc.parameters(), max_grad_norm=10.0))
        train_step = loop.make_train_step(
            {"mel/loss": 15.0, "adv/feat_loss": 2.0, "adv/gen_loss": 1.0,
             "vq/commitment_loss": 0.25, "vq/codebook_loss": 1.0, "vq/rate_loss": 2.0},
            MultiScaleSTFTLoss(window_lengths=(512,)),
            MelSpectrogramLoss(n_mels=(40,), window_lengths=(512,), mel_fmin=(0,),
                               mel_fmax=(None,)), L1Loss(), remat=remat)
        draws = gen.draws(4, torch.Generator(device=cuda).manual_seed(1), cuda)
        LAUNCHES.clear()
        metrics = train_step(state, audio, **draws)
        torch.cuda.synchronize()
        nets = (gen, disc)
        return ({k: v.item() for k, v in metrics.items()}, dict(LAUNCHES),
                torch.cat([p.detach().reshape(-1) for m in nets for p in m.parameters()]),
                torch.cat([p.grad.reshape(-1) for m in nets for p in m.parameters()]))

    m0, l0, p0, g0 = step(False)
    m1, l1, p1, g1 = step(True)
    for key, value in m0.items():
        assert abs(m1[key] - value) <= 1e-5 * max(abs(value), 1e-30), key
    assert float((g1 - g0).norm() / g0.norm()) <= 1e-4
    assert float((p1 - p0).norm() / p0.norm()) <= 1e-4
    assert l1["snake"] > l0["snake"] > 0 and l1["snake_backward"] == l0["snake_backward"]


EVAL_YML = """\
$include:
  - conf/vrvq/vrvq_a2.yml
DAC_VRVQ.encoder_dim: 8
DAC_VRVQ.decoder_dim: 128
DAC_VRVQ.n_codebooks: 4
DAC_VRVQ.codebook_size: 64
"""


def test_eval_clis_default_to_the_card(cuda, tmp_path, monkeypatch):
    """A flac decodes to its PCM; ``cli.evaluate`` and ``cli.stream_demo``
    with no ``--device`` run on ``cuda:0`` through the kernels (K2; K1 too in
    the fused stream). The flac encoder is loaded by path: on the card's
    machine another project's ``tests`` package shadows this repo's."""
    import importlib.util
    from pathlib import Path

    from vrvq_tpu_torch.cli import evaluate as cli_eval
    from vrvq_tpu_torch.cli import stream_demo as cli_stream
    from vrvq_tpu_torch.data.audio_io import read_audio
    from vrvq_tpu_torch.infer.sweep import LevelSweep

    spec = importlib.util.spec_from_file_location(
        "flac_encoder_by_path", Path(__file__).with_name("flac_encoder.py"))
    flac = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(flac)
    t = np.arange(int(1.2 * 44100)) / 44100
    pcm = np.round(0.3 * np.sin(2 * np.pi * 440 * t) * 32767).astype(np.int64)[None]
    data = tmp_path / "clips"
    data.mkdir()
    flac.write_flac(data / "split_0000_tone.flac", pcm, 44100, block_size=1024,
                    subframe_kind="lpc", order=2)
    audio, sr = read_audio(data / "split_0000_tone.flac")
    assert sr == 44100 and np.array_equal(np.round(audio * 32768.0).astype(np.int64), pcm)

    (tmp_path / "tiny.yml").write_text(EVAL_YML)
    devices = []
    real_encode = LevelSweep.encode

    def spy(self, audio):
        devices.append(audio.device)
        return real_encode(self, audio)

    monkeypatch.setattr(LevelSweep, "encode", spy)
    LAUNCHES.clear()
    report = cli_eval.main(["--args.load", str(tmp_path / "tiny.yml"), "--data_dir",
                            str(data), "--duration", "1.0", "--levels", "0.5,1",
                            "--out", str(tmp_path / "eval.json")])
    torch.cuda.synchronize()
    assert devices == [torch.device("cuda", 0)]
    assert LAUNCHES["snake_approx_bf16_cl"] > 0 and LAUNCHES["snake"] > 0, dict(LAUNCHES)
    assert report["num_examples"] == 1 and "tone" in report["per_class_top_level"]

    LAUNCHES.clear()
    res = cli_stream.main(["--args.load", str(tmp_path / "tiny.yml"), "--input",
                           str(data / "split_0000_tone.flac"), "--output",
                           str(tmp_path / "out.wav"), "--fused_quantizer", "1",
                           "--entropy", "1"])
    torch.cuda.synchronize()
    assert LAUNCHES["rvq"] > 0 and LAUNCHES["snake"] > 0, dict(LAUNCHES)
    assert res["samples"] == pcm.shape[-1]
    assert read_audio(tmp_path / "out.wav")[0].shape == pcm.shape


def _small_train_cfg(wavs, **over):
    """vrvq_a2.yml at small widths (MPD 2, one MRD of 512), 0.1 s clips."""
    cfg = port.config.Config.load(port.config.FLAGSHIP_YAML,
                                  base_dir=port.config.REPO).to_dict()
    cfg.update({
        "DAC_VRVQ.encoder_dim": 16, "DAC_VRVQ.encoder_rates": [2, 4, 8],
        "DAC_VRVQ.decoder_dim": 128, "DAC_VRVQ.decoder_rates": [8, 4, 2],
        "DAC_VRVQ.n_codebooks": 4, "DAC_VRVQ.codebook_size": 64,
        "DAC_VRVQ.codebook_dim": 4, "Discriminator.periods": [2],
        "Discriminator.fft_sizes": [512], "MultiScaleSTFTLoss.window_lengths": [512],
        "MelSpectrogramLoss.n_mels": [40], "MelSpectrogramLoss.window_lengths": [512],
        "MelSpectrogramLoss.mel_fmin": [0], "MelSpectrogramLoss.mel_fmax": [None],
        "train/build_dataset.folders": {"music": [str(wavs)]},
        "val/build_dataset.folders": {"music": [str(wavs)]},
        "train/AudioDataset.duration": 0.1, "val/AudioDataset.duration": 0.1,
        "val/AudioDataset.n_examples": 4, "batch_size": 4, "val_batch_size": 4,
        "num_iters": 2, "valid_freq": 2, **over})
    return cfg


def test_native_io_runs_on_the_card_host(cuda, tmp_path):
    """The native library builds on the card's machine and serves the wav
    reader, the loudness meter and the range coder (its counters rise)."""
    from vrvq_tpu_torch.data.audio_io import read_wav, read_wav_np
    from vrvq_tpu_torch.native import io as native_io
    from vrvq_tpu_torch.ops.rangecoder import AdaptiveCoder

    assert native_io.library() is not None, native_io.reason()
    before = dict(native_io.IO_CALLS)
    sig = port.Signal(port.synthetic_clip(1.0, 44100, 3), 44100)
    sig.write(tmp_path / "a.wav")
    assert np.array_equal(read_wav(tmp_path / "a.wav")[0], read_wav_np(tmp_path / "a.wav")[0])
    sig.loudness()
    codes = np.random.RandomState(0).randint(0, 1024, 4096)
    native, plain = AdaptiveCoder(1024, 1), AdaptiveCoder(1024, 1, backend="python")
    assert native.backend == "native" and native.encode(codes) == plain.encode(codes)
    for name in ("wav_native", "loudness_native", "rc_encode_native"):
        assert native_io.IO_CALLS[name] > before.get(name, 0), name


def test_msd_step_and_samples_default_to_the_card(cuda, tmp_path):
    """``train()`` with no device: a small codec with MSD at rates 1 and 2
    trains on ``cuda:0`` through K2 (forward and backward), every MSD
    parameter gets a gradient, and ``save_samples`` writes audio and images
    through ``torch.utils.tensorboard`` (or tensorboardX) on the card."""
    from vrvq_tpu_torch.train.trainer import train
    from vrvq_tpu_torch.train.tracker import read_events

    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i in range(4):
        port.Signal(port.synthetic_clip(1.0, 44100, 100 + i), 44100).write(
            wavs / f"c{i}.wav")
    LAUNCHES.clear()
    state = train(_small_train_cfg(wavs, **{"Discriminator.rates": [1, 2],
                                            "num_workers": 2, "sample_freq": 1,
                                            "val_idx": [0, 1]}),
                  str(tmp_path / "run"))
    torch.cuda.synchronize()
    assert state.device == torch.device("cuda")
    assert LAUNCHES["snake"] > 0 and LAUNCHES["snake_backward"] > 0, dict(LAUNCHES)
    msd = [(n, p) for n, p in state.train_state.discriminator.named_parameters()
           if n.startswith("msd_")]
    assert msd and all(p.is_cuda and bool(torch.count_nonzero(p.grad)) for _, p in msd)
    events = read_events(tmp_path / "run" / "logs")
    assert "loss/train" in events and "imp_map/sample_1" in events, sorted(events)
    assert ("recons/sample_0.wav" in events
            or (tmp_path / "run" / "logs" / "samples" / "recons_1_0.wav").exists())


def test_packed_profile_defaults_to_the_card(cuda):
    """The turbo + packed-encoder profile and a packed fast decoder of a
    codec built with no device: every parameter and buffer on the
    card, the one-shot codec through K1 and K2 there, the packed decode
    within 60 dB of the unpacked fast decoder's in (B, C, T), the layout
    the packing rearranges (the fast decoder itself runs channels-last,
    other kernels that round elsewhere)."""
    from vrvq_tpu_torch.infer import fast

    model = port.build_model(port.small_config())
    sm = fast.make_serving_model(model, encode_packed=True, decode_packed=2)
    assert all(t.is_cuda for t in (*sm.parameters(), *sm.buffers()))
    x = torch.from_numpy(port.synthetic_clip(1.0, 44100, 5)[..., :44032]).cuda()
    LAUNCHES.clear()
    with torch.inference_mode():
        codes, mask = fast.encode_codes(sm, x, 1.0)
        audio = sm.decode_from_codes(codes.long(), mask)
        ref = ncl_twin(fast.make_inference_model(model)).decode_from_codes(
            codes.long(), mask)
    torch.cuda.synchronize()
    assert LAUNCHES["rvq"] == 1 and LAUNCHES["snake_approx"] > 0, dict(LAUNCHES)
    assert LAUNCHES["snake_approx_bf16"] > 0, dict(LAUNCHES)
    err = ((audio - ref).double() ** 2).sum() / (ref.double() ** 2).sum()
    assert 10 * torch.log10(err).item() <= -60.0


def test_packed_block_0_launches_as_many_snakes(cuda):
    """The packed encoder's ``block_0`` launches K2 as often as the
    unpacked one (the tiled alpha adds no launch), at the packed shape,
    bit-identical to the plain version."""
    from vrvq_tpu_torch import kernel_times as kt
    from vrvq_tpu_torch.infer import fast

    model = port.build_model(port.FLAGSHIP, device=cuda, seed=0)
    x = torch.from_numpy(port.synthetic_clip(1.0, 44100, 6)[..., :44032]).to(cuda)
    counts = {}
    for name, m in (("unpacked", fast.make_serving_model(model)),
                    ("packed", fast.make_serving_model(model, encode_packed=True))):
        with torch.inference_mode(), kt.snake_census(m.encoder.block_0) as census:
            LAUNCHES.clear()
            m.encoder(x)
            torch.cuda.synchronize()
        counts[name] = (LAUNCHES["snake_approx"], dict(census))
    assert counts["packed"][0] == counts["unpacked"][0] > 0
    assert set(counts["packed"][1]) == {(1, 128, 22016)}, counts
    assert sum(counts["packed"][1].values()) == sum(counts["unpacked"][1].values()) == 7
    gen = torch.Generator().manual_seed(1)
    xp = (3.0 * torch.randn(1, 128, 22016, generator=gen)).to(cuda)
    alpha = (0.5 + torch.rand(64, generator=gen)).repeat(2).to(cuda)
    with torch.inference_mode():
        assert torch.equal(snake.snake(xp, alpha, True), snake.snake_plain(xp, alpha, True))


def test_padding_free_clone_of_a_packed_model_raises(cuda):
    """A packed codec has no padding-free variant on the card either:
    ``clone(padding=False)`` and ``CodecProcessor`` raise ``ValueError``."""
    import dataclasses

    packed = port.build_model(dataclasses.replace(port.small_config(), encoder_packed=True),
                              device=cuda)
    with pytest.raises(ValueError, match="packed encoder requires padding=True"):
        packed.clone(padding=False)
    with pytest.raises(ValueError, match="packed encoder requires padding=True"):
        port.CodecProcessor(packed)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _leaves_that_differ(a, b):
    """The paths at which two state dicts (nested dicts, lists, tensors,
    numbers) differ; both must have the same paths."""
    a, b = dict(_leaves(a)), dict(_leaves(b))
    assert a.keys() == b.keys()
    return [k for k, v in a.items() if not (
        torch.equal(v, b[k]) if isinstance(v, torch.Tensor) else v == b[k])]


def _step_bits(cfg, save, cuda):
    """Step 0 of ``cfg`` from its seed, built by ``trainer.load``: the
    transformed batch, the metrics, and each parameter, the gradient its
    update took and AdamW's moments after it, on the host."""
    from vrvq_tpu_torch.train import trainer

    state = trainer.load(cfg, trainer.Tracker(), save, device=cuda)
    ts = state.train_state
    audio = trainer.prepare_audio(state.train_data, trainer.load_batch(
        state.train_data, 0, int(cfg["batch_size"])), cuda)
    metrics = state.train_step(ts, audio, generator=trainer.step_generator(0, 0, cuda))
    out = {"audio": audio, **{f"metric.{k}": v for k, v in metrics.items()}}
    for net, opt in (("generator", ts.opt_g), ("discriminator", ts.opt_d)):
        for n, p in getattr(ts, net).named_parameters():
            moments = opt.adamw.state[p]
            out.update({f"{net}.{n}": p, f"{net}.{n}.grad": p.grad,
                        f"{net}.{n}.exp_avg": moments["exp_avg"],
                        f"{net}.{n}.exp_avg_sq": moments["exp_avg_sq"]})
    return {k: v.detach().reshape(-1).float().cpu().view(torch.int32)
            for k, v in out.items()}


def test_a_step_twice_gives_the_same_bits_on_the_card(cuda, tmp_path):
    """A small step (quantizer dropout, MPD's reflect pad, MRD, ShiftPhase
    in the transforms) built twice from its seed under
    ``torch.use_deterministic_algorithms(True)``, which raises at an op
    without a deterministic CUDA version: nothing raises, and both runs, and
    a third without that mode, give the same bits in the batch, the metrics,
    the parameters, the gradients and AdamW's moments."""
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i in range(4):
        port.Signal(port.synthetic_clip(1.0, 44100, 100 + i), 44100).write(
            wavs / f"c{i}.wav")
    cfg = _small_train_cfg(wavs, **{"DAC_VRVQ.quantizer_dropout": 0.25})
    try:
        torch.use_deterministic_algorithms(True)
        runs = [_step_bits(cfg, tmp_path / f"run{i}", cuda) for i in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    runs.append(_step_bits(cfg, tmp_path / "run2", cuda))
    for run in runs[1:]:
        assert not _leaves_that_differ(run, runs[0])


def test_resume_on_the_card_is_bit_exact(cuda, tmp_path):
    """As ``test_torch_trainer.py::test_resume_is_bit_exact`` on the card:
    steps 0..2 in one run against step 0, then steps 1..2 resumed from
    ``latest``: the same metrics, and every tensor of both networks and
    both optimizers equal."""
    from vrvq_tpu_torch.train import checkpoint as ckpt
    from vrvq_tpu_torch.train.trainer import train

    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i in range(4):
        port.Signal(port.synthetic_clip(1.0, 44100, 100 + i), 44100).write(
            wavs / f"c{i}.wav")
    over = {"DAC_VRVQ.quantizer_dropout": 0.25, "valid_freq": 100, "num_iters": 3}
    straight = train(_small_train_cfg(wavs, **over), str(tmp_path / "a"))
    train(_small_train_cfg(wavs, **{**over, "num_iters": 1}), str(tmp_path / "b"))
    resumed = train(_small_train_cfg(wavs, **over, resume=True), str(tmp_path / "b"))
    assert resumed.metrics == straight.metrics[1:]

    def final(path):
        return torch.load(tmp_path / path / "latest" / ckpt.STATE_FILE,
                          map_location="cpu", weights_only=True)

    assert not _leaves_that_differ(final("a"), final("b"))


NCCL_YML = """\
$include:
  - conf/vrvq/vrvq_a2.yml
DAC_VRVQ.encoder_dim: 16
DAC_VRVQ.encoder_rates: [2, 4, 8]
DAC_VRVQ.decoder_dim: 128
DAC_VRVQ.decoder_rates: [8, 4, 2]
DAC_VRVQ.n_codebooks: 4
DAC_VRVQ.codebook_size: 64
DAC_VRVQ.codebook_dim: 4
DAC_VRVQ.quantizer_dropout: 0.25
Discriminator.periods: [2]
Discriminator.fft_sizes: [512]
MultiScaleSTFTLoss.window_lengths: [512]
MelSpectrogramLoss.n_mels: [40]
MelSpectrogramLoss.window_lengths: [512]
MelSpectrogramLoss.mel_fmin: [0]
MelSpectrogramLoss.mel_fmax: [null]
batch_size: 4
val_batch_size: 4
num_iters: 2
valid_freq: 100
train/AudioDataset.duration: 0.1
val/AudioDataset.duration: 0.1
val/AudioDataset.n_examples: 4
"""


def test_nccl_ranks_train_twice_to_the_same_bits(cuda, tmp_path):
    """``cli.train`` with no flag on two or more cards (a rank a card that
    divides the batch of 4, over NCCL), twice: the same metrics at every
    step, and every tensor of both networks and both optimizers in
    ``latest`` equal."""
    import json
    import subprocess
    import sys

    from vrvq_tpu_torch.config import REPO
    from vrvq_tpu_torch.train import checkpoint as ckpt

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for i in range(4):
        port.Signal(port.synthetic_clip(1.0, 44100, 100 + i), 44100).write(
            wavs / f"c{i}.wav")
    (tmp_path / "nccl.yml").write_text(NCCL_YML)
    folders = repr({"music": [str(wavs)]})
    runs = []
    for run in ("a", "b"):
        out = subprocess.run(
            [sys.executable, "-m", "vrvq_tpu_torch.cli.train", "--args.load",
             str(tmp_path / "nccl.yml"), "--save_path", str(tmp_path / run),
             "--train/build_dataset.folders", folders,
             "--val/build_dataset.folders", folders],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        summary = json.loads(out.stdout.strip().splitlines()[-1])
        assert summary["world"] >= 2 and summary["backend"] == "nccl", summary
        runs.append((summary["metrics"], torch.load(
            tmp_path / run / "latest" / ckpt.STATE_FILE, map_location="cpu",
            weights_only=True)))
    (metrics_a, state_a), (metrics_b, state_b) = runs
    assert metrics_a == metrics_b

    assert not _leaves_that_differ(state_a, state_b)


def test_synth_corpus_train_and_measure_trained_default_to_the_card(cuda, tmp_path):
    """A corpus from ``cli.make_synth_dataset``, 2 steps of ``cli.train`` of
    ``tests/tiny_synth_demo.yml`` and ``measure`` of that checkpoint
    (``trained_flagship`` with ``min_steps=0``), with no device named: the
    model on ``cuda:0``, K1 and K2 launched, every line printed with the
    corpus as the gates' probe."""
    import contextlib
    import io
    import json
    from pathlib import Path

    from vrvq_tpu_torch.cli import make_synth_dataset as cli_synth
    from vrvq_tpu_torch.cli import measure_trained as mt
    from vrvq_tpu_torch.cli import train as cli_train

    conf = str(Path(__file__).resolve().parent / "tiny_synth_demo.yml")
    corpus = tmp_path / "corpus"
    cli_synth.main(["--out", str(corpus), "--train", "4", "--val", "2", "--test", "8",
                    "--duration", "0.3"])
    save = tmp_path / "ckpt"
    summary = cli_train.main([
        "--args.load", conf, "--save_path", str(save), "--num_iters", "2",
        "--train/build_dataset.folders", repr({"music": [str(corpus / "train")]}),
        "--val/build_dataset.folders", repr({"music": [str(corpus / "val")]})])
    assert summary["device"] != "cpu" and summary["steps"] == 2, summary
    model = mt.trained_flagship(save, min_steps=0, config=conf)
    assert next(model.parameters()).device == torch.device("cuda", 0)
    LAUNCHES.clear()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lines = mt.measure(model, 2, 0.5, str(save), str(corpus / "test"))
    torch.cuda.synchronize()
    assert [json.loads(ln) for ln in buf.getvalue().splitlines()] == json.loads(
        json.dumps(lines))
    assert len(lines) == 12
    assert all(ln["probe"] == f"held-out corpus {corpus / 'test'} (8 clips)"
               for ln in lines[1:3])
    assert LAUNCHES["rvq"] > 0 and LAUNCHES["snake"] > 0, dict(LAUNCHES)
    assert LAUNCHES["snake_approx"] > 0 and LAUNCHES["snake_approx_bf16"] > 0
