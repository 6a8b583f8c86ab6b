"""The port's layers against the JAX package's, padded and padding-free.

Same jittered parameters (JAX init -> ``state_dict_from_jax``), same seeded
numpy inputs. Tolerance rtol = atol = 1e-5: float32 convolutions of XLA and of
PyTorch sum in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu import nn as jnn
from vrvq_tpu_torch.convert import state_dict_from_jax
from vrvq_tpu_torch.nn import layers as tnn
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
