"""The model fields the port took last: a per-stage ``codebook_dim`` list,
``latent_dim``, and ``DenoisingBlock``, against the JAX package's, from the
same jittered parameters at small widths (encoder 16, decoder 128, 4
codebooks of 64).

Tolerances: codes and masks bit-identical, z_q and audio within atol 1e-5
(1e-4 for audio through the decoder, the port's other decode tests' bar);
``from_codes`` and ``from_latents`` against JAX's within 1e-5 and against the
encode they invert; ``DenoisingBlock`` within rtol = atol = 1e-5 (the layer
tests' bar). The fused quantizer takes one codebook width for every stage,
as the JAX kernel's ``jnp.stack`` does: mixed widths raise. A VBR
``DAC_VRVQ`` whose ``latent_dim`` is not the encoder's feature width fails
in the JAX package (its importance subnet reads the feature with
``latent_dim`` channels); the port raises there with the reason.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu import nn as jnn
from vrvq_tpu.audio import Signal as JaxSignal
from vrvq_tpu.infer.codec_api import CodecProcessor as JaxProcessor
from vrvq_tpu.models import DAC_MOE as JaxMOE, DAC_VRVQ as JaxDAC
import vrvq_tpu_torch as port
from vrvq_tpu_torch.config import Config, model_config
from vrvq_tpu_torch.convert import state_dict_from_jax
from vrvq_tpu_torch.models.dac_moe import DAC_MOE
from vrvq_tpu_torch.nn import layers as tnn
from vrvq_tpu_torch.ops import rvq_kernel
from tests.test_torch_support import JAX_CFG, jitter, jnp_tree, own_loudness_meters

torch.set_num_threads(1)

WIDTHS = (8, 4, 4, 2)
CASES = {
    "vbr-widths": (JaxDAC, port.DAC_VRVQ, dict(codebook_dim=WIDTHS)),
    "cbr-widths": (JaxDAC, port.DAC_VRVQ, dict(codebook_dim=WIDTHS,
                                               model_type="CBR")),
    "cbr-latent96": (JaxDAC, port.DAC_VRVQ, dict(latent_dim=96,
                                                 model_type="CBR")),
    "moe-latent96-widths": (JaxMOE, DAC_MOE, dict(latent_dim=96,
                                                  codebook_dim=WIDTHS)),
}


def _pair(case):
    jcls, tcls, overrides = CASES[case]
    jm = jcls(**{**JAX_CFG, **overrides})
    rngs = {"params": jax.random.PRNGKey(1), "vbr": jax.random.PRNGKey(2),
            "vbr_dropout": jax.random.PRNGKey(3)}
    params = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 1, 4096)), level=1.0))(rngs)
    params = jitter(jax.tree_util.tree_map(np.asarray, params), 21)
    tm = port.build_model(port.small_config(**overrides), device="cpu",
                          state_dict=state_dict_from_jax(params), model_class=tcls)
    return jm, params, tm


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return request.param, _pair(request.param)


def _audio(seed, n=16384, batch=2):
    return (np.random.RandomState(seed).randn(batch, 1, n) * 0.3).astype(np.float32)


def _request(tm):
    return {"n_quantizers": 3} if tm.config.model_type == "CBR" else {"level": 1.0}


@pytest.mark.parametrize("padding", [True, False], ids=["padded", "padless"])
def test_encode_and_decode_match_jax(pair, padding):
    _, (jm, params, tm) = pair
    jm, tm = jm.clone(padding=padding), tm.clone(padding=padding)
    jp = jnp_tree(params)
    x = _audio(1)
    req = _request(tm)
    want = jm.apply(jp, jnp.asarray(x), method=type(jm).encode, **req)
    want_audio = jm.apply(jp, want["z_q"], method=type(jm).decode)
    with torch.inference_mode():
        got = tm.encode(torch.from_numpy(x), **req)
        audio = tm.decode(got["z_q"]).numpy()
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    if got["mask_imp"] is not None:
        np.testing.assert_array_equal(got["mask_imp"].numpy(),
                                      np.asarray(want["mask_imp"]))
    d = tm.config.resolved_latent_dim
    n_codes = got["codes"].shape[1]
    assert got["z_q"].shape[1] == d
    assert got["latents"].shape[1] == sum(tm.quantizer.codebook_dims[:n_codes])
    np.testing.assert_allclose(got["latents"].numpy(), np.asarray(want["latents"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["z_q"].numpy(), np.asarray(want["z_q"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(audio, np.asarray(want_audio), rtol=0, atol=1e-4)


def test_from_codes_and_from_latents_match_jax(pair):
    """``from_latents`` splits the latents at the running sum of the
    widths; both rebuild z_q as JAX's do, and invert the encode."""
    _, (jm, params, tm) = pair
    jp = jnp_tree(params)
    x = _audio(2)
    with torch.inference_mode():
        enc = tm.encode(torch.from_numpy(x), n_quantizers=4)
        z_q, z_p, codes = tm.quantizer.from_latents(enc["latents"])
        from_codes = tm.quantizer.from_codes(enc["codes"])
    assert torch.equal(codes, enc["codes"])
    assert z_p.shape[1] == sum(tm.quantizer.codebook_dims)
    torch.testing.assert_close(z_q, enc["z_q"], rtol=0, atol=1e-5)
    torch.testing.assert_close(from_codes, enc["z_q"], rtol=0, atol=1e-5)
    lat = jnp.asarray(enc["latents"].numpy().transpose(0, 2, 1))
    jz_q, jz_p, jcodes = jm.apply(
        jp, lat, method=lambda m, a: m.quantizer.from_latents(a))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(z_q.numpy(), np.asarray(jz_q).transpose(0, 2, 1),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(z_p.numpy(), np.asarray(jz_p).transpose(0, 2, 1),
                               rtol=0, atol=1e-6)
    # a width that holds two whole stages: the first two
    two = sum(tm.quantizer.codebook_dims[:2])
    with torch.inference_mode():
        part = tm.quantizer.from_latents(enc["latents"][:, :two + 1])
    assert torch.equal(part[2], enc["codes"][:, :2])


def test_codec_processor_matches_jax(pair):
    """``.dac`` codes of the module path, chunked, equal JAX's; the fused
    path serves uniform widths only."""
    own_loudness_meters()
    name, (jm, params, tm) = pair
    clip = port.synthetic_clip(1.3, 44100, 9)
    req = {"n_quantizers": 3} if name.startswith("moe") else _request(tm)
    want = JaxProcessor(jm, jnp_tree(params)).compress(
        JaxSignal(clip, 44100), win_duration=0.5, **req)
    proc = port.CodecProcessor(tm)
    dac = proc.compress(port.Signal(clip, 44100), win_duration=0.5, **req)
    np.testing.assert_array_equal(dac.codes, np.asarray(want.codes))
    if want.vbr_counts is not None:
        np.testing.assert_array_equal(dac.vbr_counts, np.asarray(want.vbr_counts))
    out = proc.decompress(dac)
    assert out.audio_data.shape == (1, 1, clip.shape[-1])
    if name.startswith("moe"):
        with pytest.raises(ValueError, match="DAC_VRVQ only"):
            port.CodecProcessor(tm, fused_quantizer=True)
    if len(set(tm.quantizer.codebook_dims)) > 1:
        if not name.startswith("moe"):
            with pytest.raises(ValueError, match=r"\[8, 4, 4, 2\]"):
                port.CodecProcessor(tm, fused_quantizer=True)
        with pytest.raises(ValueError, match="one codebook width"):
            rvq_kernel.stack_quantizer_weights(tm.quantizer)
    elif not name.startswith("moe"):
        fused = port.CodecProcessor(tm, fused_quantizer=True).compress(
            port.Signal(clip, 44100), win_duration=0.5, **req)
        np.testing.assert_array_equal(fused.codes, dac.codes)


def test_uniform_width_list_is_the_int():
    """A list of equal widths builds the codec an int builds, and goes
    through the fused quantizer."""
    lst = port.small_config(codebook_dim=[4, 4, 4, 4])
    assert lst.codebook_dim == (4, 4, 4, 4)
    a = port.build_model(lst, device="cpu", seed=2)
    assert a.quantizer.codebook_dims == [4] * 4
    b = port.build_model(port.small_config(), device="cpu", seed=2)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    sig = port.Signal(port.synthetic_clip(1.0, 44100, 3), 44100)
    fused = port.CodecProcessor(a, fused_quantizer=True).compress(sig, level=1.0)
    plain = port.CodecProcessor(b).compress(sig, level=1.0)
    np.testing.assert_array_equal(fused.codes, plain.codes)
    with pytest.raises(ValueError, match="3 entries for 4 codebooks"):
        port.DAC_VRVQ(port.small_config(codebook_dim=(4, 4, 4)))


def test_fields_from_yaml_and_overrides(tmp_path):
    """``latent_dim`` and a ``codebook_dim`` list read from a YAML file and
    from ``--key value`` overrides; the list becomes a tuple."""
    yml = tmp_path / "fields.yml"
    yml.write_text("$include:\n  - conf/base.yml\n"
                   "DAC_VRVQ.latent_dim: 96\n"
                   "DAC_VRVQ.model_type: CBR\n"
                   "DAC_VRVQ.n_codebooks: 4\n"
                   "DAC_VRVQ.codebook_dim: [8, 4, 4, 2]\n")
    cfg = model_config(Config.load(yml, base_dir=port.config.REPO))
    assert (cfg.latent_dim, cfg.codebook_dim, cfg.resolved_latent_dim) == (
        96, (8, 4, 4, 2), 96)
    small = dataclasses.replace(cfg, encoder_dim=8, decoder_dim=64, codebook_size=32)
    model = port.build_model(small, device="cpu", seed=0)
    assert model.encoder.out_conv.v.shape[0] == 96
    with torch.inference_mode():
        enc = model.encode(torch.from_numpy(_audio(4, n=4096)), n_quantizers=4)
    assert enc["z_q"].shape[1] == 96 and enc["latents"].shape[1] == 18
    over = port.config.parse_args(
        ["--args.load", str(yml), "--DAC_VRVQ.codebook_dim", "[2, 2, 2, 2]",
         "--DAC_VRVQ.latent_dim", "null"], base_dir=port.config.REPO)
    cfg = model_config(over)
    assert cfg.codebook_dim == (2, 2, 2, 2) and cfg.latent_dim is None
    assert cfg.resolved_latent_dim == cfg.feature_dim == 1024


def test_vbr_latent_dim_off_the_feature_width_raises():
    """The JAX package fails on it; the port says why."""
    jm = JaxDAC(**{**JAX_CFG, "latent_dim": 96})
    with pytest.raises(Exception):
        jm.init({"params": jax.random.PRNGKey(0), "vbr": jax.random.PRNGKey(1),
                 "vbr_dropout": jax.random.PRNGKey(2)},
                jnp.zeros((1, 1, 4096)), level=1.0)
    with pytest.raises(ValueError, match="importance subnet takes latent_dim"):
        port.DAC_VRVQ(port.small_config(latent_dim=96))
    port.DAC_VRVQ(port.small_config(latent_dim=256))  # the feature's width


@pytest.mark.parametrize("padding", [True, False], ids=["padded", "padless"])
def test_denoising_block_matches_jax(padding):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 16, 300).astype(np.float32)
    x_btc = jnp.asarray(x.transpose(0, 2, 1))
    jblock = jnn.DenoisingBlock(16, padding=padding)
    params = jblock.init(jax.random.PRNGKey(0), x_btc)
    params = jitter(jax.tree_util.tree_map(np.asarray, params), 2)
    expected = np.asarray(jblock.apply(params, x_btc)).transpose(0, 2, 1)
    tblock = tnn.DenoisingBlock(16, padding=padding)
    tblock.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.inference_mode():
        got = tblock(torch.from_numpy(x)).numpy()
    assert got.shape == expected.shape
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5)
    drawn = port.init_params(tnn.DenoisingBlock(16), torch.Generator().manual_seed(0))
    assert (drawn.snake.alpha == 1).all() and (drawn.conv.bias == 0).all()
