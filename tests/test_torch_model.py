"""The port's DAC_VRVQ against the JAX package's, at the small test size.

``encode``: codes bit-identical, z_q within rtol 1e-3 / atol 1e-4.
``decode_from_codes``: audio within rtol 1e-3 / atol 1e-4. Both padded and
padding-free. Plus the flagship's parameter count (JAX counted abstractly
with ``jax.eval_shape``) and the codec's length arithmetic.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vrvq_tpu_torch as port
from vrvq_tpu.models import DAC_VRVQ as JaxDAC
from tests.test_torch_support import jax_model_and_params, jnp_tree, port_model

RTOL, ATOL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def models():
    jm, params = jax_model_and_params(0)
    return jm, jnp_tree(params), params


@pytest.mark.parametrize("padding", [True, False], ids=["padded", "padless"])
@pytest.mark.parametrize("level", [0.5, 1.0])
def test_encode_matches_jax(models, padding, level):
    jm, jparams, params = models
    rng = np.random.RandomState(42)
    audio = (rng.randn(2, 1, 8192) * 0.2).astype(np.float32)
    jout = jm.clone(padding=padding).apply(jparams, jnp.asarray(audio),
                                           level=level, method=JaxDAC.encode)
    tm = port_model(params, padding=padding)
    with torch.inference_mode():
        tout = tm.encode(torch.from_numpy(audio), level=level)
    np.testing.assert_array_equal(tout["codes"].numpy(), np.asarray(jout["codes"]))
    np.testing.assert_array_equal(tout["mask_imp"].numpy(),
                                  np.asarray(jout["mask_imp"]))
    np.testing.assert_allclose(tout["z_q"].numpy(), np.asarray(jout["z_q"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tout["imp_map"].numpy(),
                               np.asarray(jout["imp_map"]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("padding", [True, False], ids=["padded", "padless"])
def test_decode_from_codes_matches_jax(models, padding):
    jm, jparams, params = models
    rng = np.random.RandomState(9)
    codes = rng.randint(0, 64, (1, 4, 20)).astype(np.int32)
    mask = (np.arange(4).reshape(1, 4, 1)
            < rng.randint(1, 5, (1, 1, 20))).astype(np.float32)
    jaudio = jm.clone(padding=padding).apply(
        jparams, jnp.asarray(codes), jnp.asarray(mask),
        method=JaxDAC.decode_from_codes)
    tm = port_model(params, padding=padding)
    with torch.inference_mode():
        taudio = tm.decode_from_codes(torch.from_numpy(codes).long(),
                                      torch.from_numpy(mask))
    assert taudio.shape == jaudio.shape
    np.testing.assert_allclose(taudio.numpy(), np.asarray(jaudio),
                               rtol=RTOL, atol=ATOL)


def test_forward_matches_jax(models):
    jm, jparams, params = models
    rng = np.random.RandomState(3)
    audio = (rng.randn(1, 1, 5000) * 0.2).astype(np.float32)  # not a hop multiple
    jout = jm.apply(jparams, jnp.asarray(audio), level=1.0)
    with torch.inference_mode():
        tout = port_model(params)(torch.from_numpy(audio), level=1.0)
    assert tout["audio"].shape == (1, 1, 5000)
    np.testing.assert_array_equal(tout["codes"].numpy(), np.asarray(jout["codes"]))
    np.testing.assert_allclose(tout["audio"].numpy(), np.asarray(jout["audio"]),
                               rtol=RTOL, atol=ATOL)


def test_clone_shares_parameters(models):
    _, _, params = models
    tm = port_model(params)
    twin = tm.clone(padding=False)
    assert twin.padding is False and twin.encoder.in_conv.padding == 0
    assert twin.encoder.in_conv.v.data_ptr() == tm.encoder.in_conv.v.data_ptr()
    tm.use_kernels(False)
    assert not tm.clone(padding=True).uses_kernels()


def test_flagship_parameter_count_matches_jax():
    """81.56M parameters, counted in the JAX package without computing."""
    cfg = port.FLAGSHIP
    jm = JaxDAC(encoder_dim=cfg.encoder_dim, encoder_rates=cfg.encoder_rates,
                decoder_dim=cfg.decoder_dim, decoder_rates=cfg.decoder_rates,
                n_codebooks=cfg.n_codebooks, codebook_size=cfg.codebook_size,
                codebook_dim=cfg.codebook_dim, model_type="VBR",
                level_min=cfg.level_min, level_max=cfg.level_max,
                imp2mask_alpha=cfg.imp2mask_alpha)
    rngs = {k: jax.random.PRNGKey(i)
            for i, k in enumerate(["params", "vbr", "vbr_dropout"])}
    shapes = jax.eval_shape(
        lambda: jm.init(rngs, jnp.zeros((1, 1, 4096)), level=1.0))
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        tm = port.DAC_VRVQ(cfg)
    n_port = sum(p.numel() for p in tm.parameters())
    assert n_port == n_jax
    assert round(n_port / 1e6, 2) == 81.56


@pytest.mark.parametrize("length", [0, 1, 4096, 44100])
def test_length_arithmetic_matches_jax(models, length):
    jm, _, _ = models
    with torch.device("meta"):
        tm = port.DAC_VRVQ(port.small_config())
    assert tm.hop_length == jm.hop_length
    assert tm.delay == jm.delay
    assert tm.get_output_length(length) == jm.get_output_length(length)
