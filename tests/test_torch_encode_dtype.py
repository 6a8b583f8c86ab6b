"""The bfloat16 encoder profile, ``make_inference_model(encode_dtype=
torch.bfloat16)``, against the JAX package's ``make_inference_model(
encode_dtype='bfloat16')`` on the same jittered parameters, at the sizes of
``tests/test_torch_fast.py`` (encoder 8, decoder 128, 4 codebooks of
32 x 4).

Tolerances: the port's bfloat16 latents ``z`` within 2e-2 relative L2 of
JAX's (both encoders compute in bfloat16, and the two frameworks round the
convolutions and Snake at other places: PyTorch's Snake computes in float32
and rounds once; measured 1.00e-2 here, padded and padding-free, where
each package's bfloat16 z lies 0.8e-2 off its float32 z); JAX's bfloat16
latents fed to the JAX quantizer, to the port's and to the port's fused
quantizer give the same codes, bit for bit (the quantizer is float32 in
every profile). The
profile folds the encoder into bfloat16 kernels, hands z and the feature to
the quantizer in float32 and shares the quantizer's tensors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.infer import fast as jfast
from vrvq_tpu.models import DAC_MOE as JaxMOE
import vrvq_tpu_torch as port
from vrvq_tpu_torch.convert import state_dict_from_jax
from vrvq_tpu_torch.infer import fast
from vrvq_tpu_torch.models.dac_moe import DAC_MOE
from vrvq_tpu_torch.models.dac_vrvq import DAC_VRVQ, Profile
from vrvq_tpu_torch.ops import rvq_kernel
from tests.test_torch_support import jax_model_and_params, jitter, jnp_tree

torch.set_num_threads(1)

SIZES = dict(encoder_dim=8, codebook_size=32)
Z_REL_L2 = 2e-2


@pytest.fixture(scope="module")
def pair():
    jm, params = jax_model_and_params(0, **SIZES)
    tm = port.build_model(port.small_config(**SIZES), device="cpu",
                          state_dict=state_dict_from_jax(params))
    return jm, params, tm


def _audio(seed, n=32768, batch=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, 1, n) * 0.3).astype(np.float32)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_bf16(jm, params, x):
    """JAX's bfloat16 profile: (its model, params, z (B, D, T'))."""
    jfm, jfp = jfast.make_inference_model(jm, jnp_tree(params),
                                          encode_dtype="bfloat16")
    z = jfm.apply(jfp, jnp.asarray(x.transpose(0, 2, 1)),
                  method=lambda m, a: m.encoder(a))
    return jfm, jfp, np.asarray(z).transpose(0, 2, 1)


def test_profile_folds_the_encoder_into_bf16(pair):
    _, _, tm = pair
    bf = fast.make_inference_model(tm, encode_dtype=torch.bfloat16)
    assert bf.profile == Profile(
        encoder_folded=True, decoder_folded=True,
        decoder_compute_dtype=torch.bfloat16,
        encoder_compute_dtype=torch.bfloat16, decoder_snake_approx=True,
        encoder_snake_approx=False, encoder_packed=False, decoder_packed=0,
        decoder_packed_up=0)
    assert bf.encoder.block_1.res0.conv1.w.dtype == torch.bfloat16
    assert bf.encoder.block_1.snake.alpha.dtype == torch.float32
    assert not hasattr(bf.encoder.in_conv, "v")
    for a, b in zip(tm.quantizer.parameters(), bf.quantizer.parameters()):
        assert a.data_ptr() == b.data_ptr()
    with torch.inference_mode():
        z, feat = bf.encoder(torch.from_numpy(_audio(1, n=8192)), return_feat=True)
    assert z.dtype == feat.dtype == torch.float32
    # without decode_dtype the decoder computes in the encoder's dtype, as
    # the JAX model's compute_dtype makes it
    both = fast.make_inference_model(tm, decode_dtype=None,
                                     encode_dtype=torch.bfloat16)
    assert both.profile.decoder_compute_dtype == torch.bfloat16
    assert both.decoder.in_conv.w.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="fold it"):
        DAC_VRVQ(tm.config, profile=Profile(encoder_compute_dtype=torch.bfloat16))


@pytest.mark.parametrize("padding", [True, False], ids=["padded", "padless"])
def test_bf16_latents_match_jax(pair, padding):
    jm, params, tm = pair
    x = _audio(2)
    _, _, jz = _jax_bf16(jm.clone(padding=padding), params, x)
    bf = fast.make_inference_model(tm.clone(padding=padding),
                                   encode_dtype=torch.bfloat16)
    with torch.inference_mode():
        z = bf.encoder(torch.from_numpy(x)).numpy()
        z32 = tm.clone(padding=padding).encoder(torch.from_numpy(x)).numpy()
    assert z.shape == jz.shape
    err = _rel_l2(z, jz)
    assert err <= Z_REL_L2, err
    # and bfloat16 moved them: well off the float32 latents, as JAX's are
    assert _rel_l2(z, z32) > 1e-4 and _rel_l2(jz, z32) > 1e-4


def test_jax_bf16_latents_give_the_same_codes_in_both_quantizers(pair):
    jm, params, tm = pair
    x = _audio(3)
    jfm, jfp, jz = _jax_bf16(jm, params, x)
    jz_btd = jnp.asarray(jz.transpose(0, 2, 1))
    jcodes = jfm.apply(
        jfp, jz_btd, n_quantizers=4, method=lambda m, z, n_quantizers: m.quantizer(
            z, n_quantizers=n_quantizers, feat_enc=None))["codes"]
    bf = fast.make_inference_model(tm, encode_dtype=torch.bfloat16)
    z = torch.from_numpy(np.ascontiguousarray(jz))
    with torch.inference_mode():
        module = bf.quantizer(z, n_quantizers=4)["codes"]
        _, fused = rvq_kernel.quantize_fused(
            rvq_kernel.prepare_rvq(rvq_kernel.stack_quantizer_weights(bf.quantizer)), z)
    np.testing.assert_array_equal(module.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(fused.numpy(), np.asarray(jcodes))


def test_bf16_profile_serves_and_moves_few_codes(pair):
    """Through ``CodecProcessor`` with the fused quantizer: the bfloat16
    profile's codes differ from the float32 encoder's in a few stages only
    (near ties move under any rounding), and decode."""
    _, _, tm = pair
    sig = port.Signal(port.synthetic_clip(1.3, 44100, 4), 44100)
    exact = port.CodecProcessor(fast.make_inference_model(tm), fused_quantizer=True)
    bf = port.CodecProcessor(fast.make_inference_model(tm, encode_dtype="bfloat16"),
                             fused_quantizer=True)
    a = exact.compress(sig, win_duration=0.5, level=1.0)
    b = bf.compress(sig, win_duration=0.5, level=1.0)
    assert a.codes.shape == b.codes.shape
    assert (a.codes != b.codes).mean() < 0.25
    assert np.isfinite(bf.decompress(b).audio_data).all()


def test_moe_profiles():
    """``make_inference_model`` takes a ``DAC_MOE``: the exact-codes
    profile keeps its codes and masks, the bfloat16 encoder is folded."""
    jm = JaxMOE(encoder_dim=8, decoder_dim=64, n_codebooks=4, codebook_size=32,
                codebook_dim=4, level_min=1.0, level_max=1.0)
    params = jm.init({"params": jax.random.PRNGKey(0), "vbr": jax.random.PRNGKey(1),
                      "vbr_dropout": jax.random.PRNGKey(2)},
                     jnp.zeros((1, 1, 4096)), level=1.0)
    params = jitter(jax.tree_util.tree_map(np.asarray, params), 5)
    tm = port.build_model(port.small_config(encoder_dim=8, decoder_dim=64,
                                            codebook_size=32),
                          device="cpu", state_dict=state_dict_from_jax(params),
                          model_class=DAC_MOE)
    x = torch.from_numpy(_audio(6, n=8192))
    with torch.inference_mode():
        live = tm.encode(x, level=1.0)
        for encode_dtype in (None, torch.bfloat16):
            prof = fast.make_inference_model(tm, encode_dtype=encode_dtype)
            assert isinstance(prof, DAC_MOE)
            out = prof.encode(x, level=1.0)
            assert torch.isfinite(prof.decode_from_codes(out["codes"],
                                                         out["mask_imp"])).all()
            if encode_dtype is None:
                assert torch.equal(out["codes"], live["codes"])
                assert torch.equal(out["mask_imp"], live["mask_imp"])
        gate = fast.turbo_gate(tm, clips=_audio(7, n=8192))
    assert 0.0 <= gate.mask_agreement <= 1.0
