"""The port's layers against the JAX package's, padded and padding-free.

Same jittered parameters (JAX init -> ``state_dict_from_jax``), same seeded
numpy inputs. Tolerance rtol = atol = 1e-5: float32 convolutions of XLA and of
PyTorch sum in different orders.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu import nn as jnn
from vrvq_tpu_torch.convert import state_dict_from_jax
from vrvq_tpu_torch.nn import layers as tnn
from vrvq_tpu_torch.ops import snake as snake_ops
from tests.test_torch_support import jitter

RTOL = ATOL = 1e-5

CASES = {
    "conv_k7": (lambda pm: jnn.WNConv1d(8, 12, 7, padding=3, pad_mode=pm),
                lambda pm: tnn.WNConv1d(8, 12, 7, padding=3, pad_mode=pm), 8),
    "conv_dilated": (lambda pm: jnn.WNConv1d(8, 8, 7, padding=9, dilation=3, pad_mode=pm),
                     lambda pm: tnn.WNConv1d(8, 8, 7, padding=9, dilation=3, pad_mode=pm), 8),
    "conv_strided": (lambda pm: jnn.WNConv1d(8, 16, 8, stride=4, padding=2, pad_mode=pm),
                     lambda pm: tnn.WNConv1d(8, 16, 8, stride=4, padding=2, pad_mode=pm), 8),
    "snake": (lambda pm: jnn.Snake1d(8), lambda pm: tnn.Snake1d(8), 8),
    "residual_unit": (lambda pm: jnn.ResidualUnit(8, dilation=3, padding=pm == "zeros"),
                      lambda pm: tnn.ResidualUnit(8, 3, padding=pm == "zeros"), 8),
    "encoder_block": (lambda pm: jnn.EncoderBlock(16, stride=4, padding=pm == "zeros"),
                      lambda pm: tnn.EncoderBlock(16, 4, padding=pm == "zeros"), 8),
    "decoder_block": (lambda pm: jnn.DecoderBlock(16, 8, stride=4, padding=pm == "zeros"),
                      lambda pm: tnn.DecoderBlock(16, 8, 4, padding=pm == "zeros"), 16),
}


@pytest.mark.parametrize("pad_mode", ["zeros", "none"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_layer_matches_jax(case, pad_mode):
    make_jax, make_port, cin = CASES[case]
    rng = np.random.RandomState(sorted(CASES).index(case))
    x = rng.randn(2, cin, 200).astype(np.float32)  # (B, C, T)
    x_btc = jnp.asarray(x.transpose(0, 2, 1))

    jlayer = make_jax(pad_mode)
    params = jlayer.init(jax.random.PRNGKey(0), x_btc)
    params = jitter(jax.tree_util.tree_map(np.asarray, params), 1)
    expected = np.asarray(jlayer.apply(params, x_btc)).transpose(0, 2, 1)

    tlayer = make_port(pad_mode)
    tlayer.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = tlayer(torch.from_numpy(x)).numpy()
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pad_mode,t_out", [("zeros", 800), ("none", 726)])
def test_decoder_block_output_length(pad_mode, t_out):
    """Transposed-conv length (T - 1) * s - 2p + k; padding off, p = 0 and
    the three k=7 units (dilation 1/3/9) shrink it by 2 * 3 * 13 = 78
    (T = 200, stride 4, k = 8, p = 2)."""
    block = tnn.DecoderBlock(16, 8, 4, padding=pad_mode == "zeros")
    for p in block.parameters():
        torch.nn.init.uniform_(p, 0.5, 1.0)
    with torch.inference_mode():
        assert block(torch.zeros(1, 16, 200)).shape == (1, 8, t_out)


def _channels_last(x):
    return x.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("approx", [False, True], ids=["exact", "poly"])
def test_snake_plain_is_layout_agnostic(dtype, approx):
    """The Snake's plain version (what a CPU tensor runs, and the kernels'
    yardstick) gives the same values on channels-last memory as on
    contiguous memory, and keeps the layout it was given."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy((3 * rng.randn(2, 13, 301)).astype(np.float32)).to(dtype)
    alpha = torch.from_numpy(rng.uniform(0.5, 1.5, 13).astype(np.float32))
    xl = _channels_last(x)
    got = snake_ops.snake_plain(xl, alpha, approx)
    assert torch.equal(got, snake_ops.snake_plain(x, alpha, approx))
    assert got.stride() == xl.stride()
    layer = tnn.Snake1d(13, approx)
    layer.alpha.data.copy_(alpha)
    with torch.inference_mode():
        assert torch.equal(layer(xl), layer(x))


def test_is_channels_last_reads_the_strides():
    x = torch.zeros(2, 5, 7)
    assert not snake_ops.is_channels_last(x)
    assert snake_ops.is_channels_last(_channels_last(x))
    assert not snake_ops.is_channels_last(_channels_last(x[:, :1]))  # one channel: both
    assert tnn.to_channels_last(x).stride() == (35, 1, 5)
    for other in (_channels_last(x)[..., 1:-1], x[..., ::2], x.transpose(0, 1)):
        with pytest.raises(ValueError, match="contiguous or channels-last"):
            snake_ops.is_channels_last(other)


CL_CONVS = {
    "conv_k7_dilated": lambda pm, cl: tnn.WNConv1d(
        8, 12, 7, padding=9, dilation=3, pad_mode=pm, folded=True, channels_last=cl),
    "conv_k1": lambda pm, cl: tnn.WNConv1d(8, 12, 1, folded=True, channels_last=cl),
    "conv_strided": lambda pm, cl: tnn.WNConv1d(
        8, 16, 8, stride=4, padding=2, pad_mode=pm, folded=True, channels_last=cl),
    "conv_transposed": lambda pm, cl: tnn.WNConvTranspose1d(
        8, 6, 8, stride=4, padding=2, pad_mode=pm, folded=True, channels_last=cl),
    # the convs cuDNN gets in another form: dilated past 3, or to one channel
    "conv_k7_dilation9": lambda pm, cl: tnn.WNConv1d(
        16, 16, 7, padding=27, dilation=9, pad_mode=pm, folded=True, channels_last=cl),
    "conv_to_one_channel": lambda pm, cl: tnn.WNConv1d(
        16, 1, 7, padding=3, pad_mode=pm, folded=True, channels_last=cl),
}
# conv_form of each (fewer than 16 outputs: widened)
FORMS = {"conv_k7_dilated": "wide", "conv_k1": "wide", "conv_strided": "nhwc",
         "conv_k7_dilation9": "phases", "conv_to_one_channel": "wide"}


@pytest.mark.parametrize("pad_mode", ["zeros", "none"])
@pytest.mark.parametrize("case", sorted(CL_CONVS))
def test_channels_last_conv_matches_ncl(case, pad_mode):
    """A folded conv run channels-last (2-D convs over NHWC views, in the
    form ``conv_form`` names) against the same parameters in (B, C, T): the
    same output within the float32 tolerance, in channels-last memory; the
    kernel keeps its shape and is stored channels-last."""
    rng = np.random.RandomState(sorted(CL_CONVS).index(case))
    ncl, last = (CL_CONVS[case](pad_mode, cl) for cl in (False, True))
    if not isinstance(last, tnn.WNConvTranspose1d):
        form = tnn.conv_form(last.w.shape[0], last.stride, last.padding,
                             last.dilation, last.groups)
        assert form == FORMS[case]
    for p in ncl.parameters():
        p.data.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    last.load_state_dict(ncl.state_dict())
    assert last.w.shape == ncl.w.shape and last.w.transpose(1, 2).is_contiguous()
    cin = ncl.w.shape[0 if case == "conv_transposed" else 1]
    x = torch.from_numpy(rng.randn(2, cin, 200).astype(np.float32))
    with torch.inference_mode():
        want = ncl(x)
        got = last(_channels_last(x))
    assert got.transpose(1, 2).is_contiguous()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


def test_channels_last_conv_is_folded_and_unpacked():
    with pytest.raises(ValueError, match="folded and unpacked"):
        tnn.WNConv1d(8, 8, 7, padding=3, channels_last=True)
    with pytest.raises(ValueError, match="folded and unpacked"):
        tnn.WNConv1d(8, 8, 7, padding=3, folded=True, time_pack_in=2,
                     time_pack_out=2, channels_last=True)


def test_conv_form_reshapes_what_cudnn_serves_without_tensor_cores():
    """``conv_form``: a conv to fewer than 16 channels widened, one dilated
    past 3 at stride 1 (padding a multiple of the dilation) split into
    phases, the rest as they are; the flagship decoder's dilation-9 convs
    and out conv, not its others. ``conv_last`` in each form gives the
    (B, C, T) conv's values, in channels-last memory, at frame counts that
    the dilation divides and that it does not."""
    assert tnn.conv_form(768, 1, 27, 9) == "phases" and tnn.conv_form(1, 1, 3) == "wide"
    assert tnn.conv_form(768, 1, 9, 3) == tnn.conv_form(768, 1, 3, 1) == "nhwc"
    assert tnn.conv_form(64, 2, 36, 9) == tnn.conv_form(64, 1, 36, 9, 2) == "nhwc"
    assert tnn.conv_form(64, 1, 13, 9) == "nhwc"  # padding off the phases
    assert tnn.conv_form(8, 1, 36, 9) == "wide"
    for t, (cout, dilation, padding) in itertools.product(
            (45, 50, 3), ((4, 4, 12), (1, 1, 3), (20, 9, 0), (5, 11, 33))):
        x = torch.randn(2, 32, t).bfloat16()
        w = torch.randn(cout, 32, 7).bfloat16()
        if t + 2 * padding <= dilation * 6:
            continue
        got = tnn.conv_last(_channels_last(x), _channels_last(w), 1, padding, dilation)
        want = torch.nn.functional.conv1d(x.float(), w.float(), None, 1, padding,
                                          dilation).bfloat16()
        assert got.shape == want.shape and got.stride(1) == 1
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-5 * want.float().abs().max().item())
