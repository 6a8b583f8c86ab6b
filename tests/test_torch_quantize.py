"""The port's VBR quantizer and masks against the JAX package's, in eval.

Same jittered parameters and seeded numpy inputs. Codes and masks must be
identical; z_q, z_q_is and the importance map within rtol = atol = 1e-5
(float32 matmuls and transcendental functions of XLA and PyTorch differ in
the last bits).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.models.quantize import VBRResidualVectorQuantize as JaxVBR
from vrvq_tpu.ops import masks as jmasks
from vrvq_tpu_torch.convert import state_dict_from_jax
from vrvq_tpu_torch.models.quantize import VBRResidualVectorQuantize
from vrvq_tpu_torch.ops import masks as tmasks
from tests.test_torch_support import jitter

TOL = 1e-5
DIM, NQ, K, D = 64, 4, 32, 8


@pytest.fixture(scope="module")
def quantizers():
    jm = JaxVBR(input_dim=DIM, n_codebooks=NQ, codebook_size=K,
                codebook_dim=D, level_min=0.125, level_max=6.0,
                imp2mask_alpha=2.0)
    z = jnp.zeros((1, 8, DIM))
    params = jm.init({"params": jax.random.PRNGKey(3),
                      "vbr": jax.random.PRNGKey(4),
                      "vbr_dropout": jax.random.PRNGKey(5)},
                     z, feat_enc=z, level=1.0)
    params = jitter(jax.tree_util.tree_map(np.asarray, params), 7)
    tq = VBRResidualVectorQuantize(DIM, NQ, K, D, imp2mask_alpha=2.0)
    tq.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, jax.tree_util.tree_map(jnp.asarray, params), tq.eval()


def _run_both(quantizers, t_feat, **kwargs):
    """Both quantizers on the same seeded z (B, D, T) and feature."""
    jm, jparams, tq = quantizers
    rng = np.random.RandomState(t_feat)
    z = rng.randn(2, DIM, 24).astype(np.float32)
    feat = rng.randn(2, DIM, t_feat).astype(np.float32)
    jout = jm.apply(jparams, jnp.asarray(z.transpose(0, 2, 1)),
                    feat_enc=jnp.asarray(feat.transpose(0, 2, 1)), **kwargs)
    with torch.inference_mode():
        tout = tq(torch.from_numpy(z), feat_enc=torch.from_numpy(feat), **kwargs)
    return jout, tout


# t_feat 26: a padding-free encoder's feature, 2 frames longer than z
@pytest.mark.parametrize("level", [0.3, 1.0, 2.5])
@pytest.mark.parametrize("t_feat", [24, 26])
def test_vbr_matches_jax(quantizers, level, t_feat):
    jout, tout = _run_both(quantizers, t_feat, level=level)
    np.testing.assert_array_equal(tout["codes"].numpy(), np.asarray(jout["codes"]))
    np.testing.assert_array_equal(tout["mask_imp"].numpy(),
                                  np.asarray(jout["mask_imp"]))
    np.testing.assert_allclose(tout["imp_map"].numpy(), np.asarray(jout["imp_map"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tout["z_q"].numpy(),
                               np.asarray(jout["z_q"]).transpose(0, 2, 1),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tout["z_q_is"].numpy(),
                               np.asarray(jout["z_q_is"]).transpose(0, 1, 3, 2),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tout["latents"].numpy(),
                               np.asarray(jout["latents"]).transpose(0, 2, 1),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_quantizers", [1, 2, NQ])
def test_cbr_fallback_matches_jax(quantizers, n_quantizers):
    jout, tout = _run_both(quantizers, 24, n_quantizers=n_quantizers)
    assert tout["imp_map"] is None and jout["imp_map"] is None
    assert tout["codes"].shape == (2, n_quantizers, 24)
    np.testing.assert_array_equal(tout["codes"].numpy(), np.asarray(jout["codes"]))
    np.testing.assert_allclose(tout["z_q"].numpy(),
                               np.asarray(jout["z_q"]).transpose(0, 2, 1),
                               rtol=TOL, atol=TOL)


def test_level_none_and_bad_n_quantizers_raise(quantizers):
    _, _, tq = quantizers
    z = torch.zeros(1, DIM, 4)
    with pytest.raises(ValueError, match="level"):
        tq(z, feat_enc=z, level=None)
    with pytest.raises(ValueError, match="n_quantizers"):
        tq(z, n_quantizers=NQ + 1)


def test_from_codes_matches_jax(quantizers):
    jm, jparams, tq = quantizers
    rng = np.random.RandomState(11)
    codes = rng.randint(0, K, (2, NQ, 24)).astype(np.int32)
    mask = (rng.rand(2, NQ, 24) > 0.5).astype(np.float32)
    jzq = jm.apply(jparams, jnp.asarray(codes), mask=jnp.asarray(mask),
                   method=JaxVBR.from_codes)[0]
    with torch.inference_mode():
        tzq = tq.from_codes(torch.from_numpy(codes).long(),
                            mask=torch.from_numpy(mask))
    np.testing.assert_allclose(tzq.numpy(), np.asarray(jzq).transpose(0, 2, 1),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("fn", ["logcosh", "ste", "hard"])
def test_masks_match_jax(fn):
    rng = np.random.RandomState(0)
    x = (rng.rand(3, 1, 50) * 10.0).astype(np.float32)
    x[0, 0, :4] = [0.0, 1.0, 2.0, 3.0]  # exactly on the stage thresholds
    if fn == "logcosh":
        pmk = (rng.randn(3, 8, 50) * 3.0).astype(np.float32)
        got = tmasks.logcosh(2.0, torch.from_numpy(pmk)).numpy()
        want = np.asarray(jmasks.logcosh(2.0, jnp.asarray(pmk)))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        return
    if fn == "ste":
        got = tmasks.generate_mask_ste(torch.from_numpy(x), 8, alpha=2.0).numpy()
        want = np.asarray(jmasks.generate_mask_ste(jnp.asarray(x), 8, alpha=2.0))
    else:
        got = tmasks.generate_mask_hard(torch.from_numpy(x), 8).numpy()
        want = np.asarray(jmasks.generate_mask_hard(jnp.asarray(x), 8))
    np.testing.assert_array_equal(got, want)
