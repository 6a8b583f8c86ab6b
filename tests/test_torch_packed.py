"""The port's time-packed layouts against the JAX package's
(``vrvq_tpu/nn/layers.py`` ``pack_*_kernel`` and the ``time_pack*`` fields,
``Encoder.packed``, ``Decoder.packed_blocks`` / ``packed_up_blocks``,
``make_inference_model(encode_packed=, decode_packed=, decode_packed_up=)``),
on the geometries of ``tests/test_packed.py`` and its tiny model (encoder 8,
decoder 32, 4 codebooks of 32 x 4, rates 2/4/4 and 4/4/2), with seeded JAX
parameters carried in by ``convert.state_dict_from_jax``. JAX's parameter
trees come from ``jax.eval_shape`` of its ``init``, filled from a seeded
numpy generator (no bias zero, no alpha one, ``g`` off ``||v||``), and every
JAX call is jitted: this file stays cheap on the CPU.

Tolerances:
  * packed kernels: equal to JAX's entry for entry (transposed to the port's
    ``(Q * out, P * in, taps)`` layout), with the same paddings; a packing
    JAX refuses, the port refuses with the same message;
  * packed modules (conv, transposed conv, ResidualUnit, EncoderBlock,
    DecoderBlock, chained and up-only): within 1e-5 relative of JAX's
    packed modules (float32 convolutions of XLA and PyTorch sum in other
    orders), as ``test_torch_layers.py``;
  * the tiny model: latents, feature and imp_map within 1e-5 of their
    largest magnitude; codes equal except on near-tie frames (top-2 margin
    <= 1e-5 in either package's latents), masks equal; the decode within
    1e-5 of its largest magnitude;
  * gradients: the port's packed model against its unpacked one (the same
    function), input and parameter gradients within 1e-5 of their largest
    magnitude.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from vrvq_tpu.nn import layers as jnn
from vrvq_tpu.infer import fast as jfast
from vrvq_tpu.models import DAC_MOE as JaxMOE
from vrvq_tpu.models import DAC_VRVQ as JaxDAC
from vrvq_tpu.models.dac_vrvq import Decoder as JaxDecoder
from vrvq_tpu.models.dac_vrvq import Encoder as JaxEncoder
import vrvq_tpu_torch as port
from vrvq_tpu_torch.convert import state_dict_from_jax
from vrvq_tpu_torch.infer import fast
from vrvq_tpu_torch.models.dac_moe import DAC_MOE
from vrvq_tpu_torch.models.dac_vrvq import Decoder, Encoder
from vrvq_tpu_torch.nn import layers as tnn
from vrvq_tpu_torch.ops import rvq_kernel
from vrvq_tpu_torch.ops.snake import snake_plain
from tests.test_torch_support import jnp_tree

torch.set_num_threads(1)

REL = 1e-5
TIE_MARGIN = 1e-5
# tests/test_packed.py's tiny model; the port's config adds the JAX
# defaults that differ from its own (imp2mask_alpha)
TINY = dict(encoder_dim=8, decoder_dim=32, n_codebooks=4, codebook_size=32,
            codebook_dim=4, encoder_rates=(2, 4, 4), decoder_rates=(4, 4, 2))
PORT_TINY = port.ModelConfig(**TINY, imp2mask_alpha=1.0)
VARIANTS = {"encoder_packed": dict(encoder_packed=True),
            "decoder_packed_1": dict(decoder_packed=1),
            "decoder_packed_2": dict(decoder_packed=2),
            "decoder_packed_up_1": dict(decoder_packed_up=1),
            "decoder_packed_up_2": dict(decoder_packed_up=2)}


def _seeded(module, seed, *args, **kwargs):
    """A parameter tree of ``module.init(*args, **kwargs)``'s structure,
    traced by ``jax.eval_shape``, filled from a seeded numpy generator: ``g``
    near an initial ``||v||`` (~0.58), biases around 0, alpha in [0.5, 1.5],
    every other leaf N(0, 1)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(module.init, *args, **kwargs)

    def leaf(path, s):
        name = path[-1].key
        if name == "g":
            return rng.uniform(0.4, 0.8, s.shape).astype(np.float32)
        if name == "alpha":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        scale = 0.05 if name == "bias" else 1.0
        return (scale * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# ----------------------------------------------------------------- kernels

CONV_GEOMETRIES = [  # tests/test_packed.py: k, dilation, stride, padding, P, Q
    (7, 1, 1, 3, 2, 2), (7, 3, 1, 9, 2, 2), (7, 9, 1, 27, 2, 2),
    (1, 1, 1, 0, 2, 2), (4, 1, 2, 1, 2, 1), (7, 1, 1, 3, 4, 4),
    (7, 3, 1, 9, 4, 2), (4, 1, 2, 1, 4, 2),
]
TRANSPOSED_GEOMETRIES = [  # k, stride, padding, P (Q = P * stride)
    (4, 2, 1, 1), (8, 4, 2, 1), (16, 8, 4, 1), (4, 2, 1, 4), (8, 4, 2, 2),
]
BAD_TRANSPOSED = [(4, 2, 1, 1, 4)]  # k, stride, padding, P, Q != P * stride


def _kernel_case(kind, geometry):
    """(JAX thunk, port thunk, transpose of JAX's kernel to the port's)."""
    rng = np.random.RandomState(hash((kind, geometry)) % 2 ** 31)
    if kind == "conv":
        k, dil, stride, pad, p, q = geometry
        w = rng.randn(k, 6, 10).astype(np.float32)  # WIO
        kw = dict(dilation=dil, stride=stride, padding=pad, pack_in=p, pack_out=q)
        return (lambda: jnn.pack_conv_kernel(jnp.asarray(w), **kw),
                lambda: tnn.pack_conv_kernel(torch.from_numpy(w.transpose(2, 1, 0).copy()),
                                             **kw))
    k, stride, pad, p, *q = geometry
    q = q[0] if q else p * stride
    w = rng.randn(6, 10, k).astype(np.float32)  # (in, out, k) in both
    kw = dict(stride=stride, padding=pad, pack_in=p, pack_out=q)
    return (lambda: jnn.pack_convtranspose_kernel(jnp.asarray(w), **kw),
            lambda: tnn.pack_convtranspose_kernel(torch.from_numpy(w), **kw))


@pytest.mark.parametrize("kind,geometry",
                         [("conv", g) for g in CONV_GEOMETRIES]
                         + [("transposed", g) for g in TRANSPOSED_GEOMETRIES + BAD_TRANSPOSED])
def test_packed_kernel_equals_jax_entry_for_entry(kind, geometry):
    jax_thunk, port_thunk = _kernel_case(kind, geometry)
    try:
        jk, jlo, jtau = jax_thunk()
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            port_thunk()
        assert str(got.value) == str(e)
        return
    tk, tlo, ttau = port_thunk()
    assert (tlo, ttau) == (jlo, jtau)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).transpose(2, 1, 0))


def test_pack_time_is_jax_reshape():
    """``pack_time`` of (B, C, T) is JAX's reshape of (B, T, C) to
    (B, T/P, P*C), transposed; ``unpack_time`` undoes it."""
    x = np.random.RandomState(0).randn(2, 3, 24).astype(np.float32)
    packed = tnn.pack_time(torch.from_numpy(x), 4)
    want = x.transpose(0, 2, 1).reshape(2, 6, 12).transpose(0, 2, 1)
    np.testing.assert_array_equal(packed.numpy(), want)
    assert torch.equal(tnn.unpack_time(packed, 4), torch.from_numpy(x))


# ----------------------------------------------------------------- modules

MODULES = {  # JAX module, port module, input channels, P in, Q out, T
    "conv_d3": (lambda: jnn.WNConv1d(8, 8, 7, padding=9, dilation=3,
                                     time_pack_in=2, time_pack_out=2),
                lambda: tnn.WNConv1d(8, 8, 7, padding=9, dilation=3,
                                     time_pack_in=2, time_pack_out=2), 8, 2, 2, 128),
    "conv_down": (lambda: jnn.WNConv1d(8, 16, 4, stride=2, padding=1,
                                       time_pack_in=2, time_pack_out=1),
                  lambda: tnn.WNConv1d(8, 16, 4, stride=2, padding=1,
                                       time_pack_in=2, time_pack_out=1), 8, 2, 1, 128),
    "conv_transpose": (lambda: jnn.WNConvTranspose1d(6, 10, 4, stride=2, padding=1,
                                                     time_pack_in=1, time_pack_out=2),
                       lambda: tnn.WNConvTranspose1d(6, 10, 4, stride=2, padding=1,
                                                     time_pack_in=1, time_pack_out=2),
                       6, 1, 2, 64),
    "residual_unit_d1": (lambda: jnn.ResidualUnit(8, dilation=1, time_pack=2),
                         lambda: tnn.ResidualUnit(8, 1, time_pack=2), 8, 2, 2, 128),
    "residual_unit_d3": (lambda: jnn.ResidualUnit(8, dilation=3, time_pack=2),
                         lambda: tnn.ResidualUnit(8, 3, time_pack=2), 8, 2, 2, 128),
    "residual_unit_d9": (lambda: jnn.ResidualUnit(8, dilation=9, time_pack=2),
                         lambda: tnn.ResidualUnit(8, 9, time_pack=2), 8, 2, 2, 128),
    "encoder_block": (lambda: jnn.EncoderBlock(16, stride=2, time_pack=2),
                      lambda: tnn.EncoderBlock(16, 2, time_pack=2), 8, 2, 1, 128),
    "decoder_block": (lambda: jnn.DecoderBlock(16, 8, stride=2, packed=True),
                      lambda: tnn.DecoderBlock(16, 8, 2, packed=True), 16, 1, 2, 64),
    "decoder_block_chained": (
        lambda: jnn.DecoderBlock(8, 4, stride=2, packed=True, time_pack_in=4),
        lambda: tnn.DecoderBlock(8, 4, 2, packed=True, time_pack_in=4), 8, 4, 8, 128),
    "decoder_block_up_only": (
        lambda: jnn.DecoderBlock(16, 8, stride=4, packed_up_only=True),
        lambda: tnn.DecoderBlock(16, 8, 4, packed_up_only=True), 16, 1, 1, 32),
}


@pytest.mark.parametrize("case", sorted(MODULES))
def test_packed_module_matches_jax(case):
    """A packed module on the packed layout against JAX's packed module,
    same parameters; the output compared in the packed layout."""
    make_jax, make_port, cin, p, q, t = MODULES[case]
    rng = np.random.RandomState(sorted(MODULES).index(case))
    x = rng.randn(2, t, cin).astype(np.float32)  # (B, T, C), unpacked
    xp = x.reshape(2, t // p, p * cin)  # JAX's packing
    jlayer = make_jax()
    params = _seeded(jlayer, 1, jax.random.PRNGKey(0), jnp.asarray(xp))
    expected = np.asarray(jax.jit(jlayer.apply)(params, jnp.asarray(xp)))
    tlayer = make_port()
    if isinstance(tlayer, tnn.WNConvTranspose1d):  # the (in, out, k) layout as it is
        state = {k: torch.from_numpy(v) for k, v in params["params"].items()}
    else:
        state = state_dict_from_jax(params)
    tlayer.load_state_dict(state, strict=True)
    with torch.inference_mode():
        got = tlayer(tnn.pack_time(torch.from_numpy(x.transpose(0, 2, 1).copy()), p))
    _close(got.numpy(), expected.transpose(0, 2, 1))
    assert got.shape[1] % q == 0


# ------------------------------------------------------------ value errors

def _module_error(module, x):
    return lambda: jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros(x))


def _model_error(model, x, **kw):
    def thunk():
        params = jax.eval_shape(JaxDAC(**TINY).init, _rngs(), jnp.zeros(x))
        jax.eval_shape(lambda p: model.apply(p, jnp.zeros(x), **kw), params)
    return thunk


ERRORS = {
    "conv_zero_padding": (
        _module_error(jnn.WNConv1d(4, 4, 7, padding=3, pad_mode="none",
                                   time_pack_in=2, time_pack_out=2), (1, 16, 8)),
        lambda: tnn.WNConv1d(4, 4, 7, padding=3, pad_mode="none",
                             time_pack_in=2, time_pack_out=2)),
    "conv_groups": (
        _module_error(jnn.WNConv1d(4, 4, 7, padding=3, groups=2,
                                   time_pack_in=2, time_pack_out=2), (1, 16, 8)),
        lambda: tnn.WNConv1d(4, 4, 7, padding=3, groups=2,
                             time_pack_in=2, time_pack_out=2)),
    "conv_bad_packing": (
        _module_error(jnn.WNConv1d(4, 4, 7, padding=3, time_pack_in=2), (1, 16, 8)),
        lambda: tnn.WNConv1d(4, 4, 7, padding=3, time_pack_in=2)),
    "conv_output_length": (
        _module_error(jnn.WNConv1d(4, 4, 4, padding=1, time_pack_in=2,
                                   time_pack_out=2), (1, 16, 8)),
        lambda: tnn.WNConv1d(4, 4, 4, padding=1, time_pack_in=2, time_pack_out=2)(
            torch.zeros(1, 8, 16))),
    "transposed_zero_padding": (
        _module_error(jnn.WNConvTranspose1d(4, 4, 4, stride=2, padding=1,
                                            pad_mode="none", time_pack_out=2),
                      (1, 16, 4)),
        lambda: tnn.WNConvTranspose1d(4, 4, 4, stride=2, padding=1, pad_mode="none",
                                      time_pack_out=2)),
    "transposed_bad_packing": (
        _module_error(jnn.WNConvTranspose1d(4, 4, 4, stride=2, padding=1,
                                            time_pack_out=4), (1, 16, 4)),
        lambda: tnn.WNConvTranspose1d(4, 4, 4, stride=2, padding=1, time_pack_out=4)),
    "residual_unit_padding": (
        _module_error(jnn.ResidualUnit(4, padding=False, time_pack=2), (1, 16, 8)),
        lambda: tnn.ResidualUnit(4, padding=False, time_pack=2)),
    "encoder_block_stride": (
        _module_error(jnn.EncoderBlock(dim=8, stride=4, time_pack=2), (1, 32, 8)),
        lambda: tnn.EncoderBlock(8, 4, time_pack=2)),
    "decoder_block_time_pack_in": (
        _module_error(jnn.DecoderBlock(8, 4, stride=2, time_pack_in=2), (1, 16, 16)),
        lambda: tnn.DecoderBlock(8, 4, 2, time_pack_in=2)),
    "decoder_block_exclusive": (
        _module_error(jnn.DecoderBlock(8, 4, stride=2, packed=True,
                                       packed_up_only=True), (1, 16, 8)),
        lambda: tnn.DecoderBlock(8, 4, 2, packed=True, packed_up_only=True)),
    "decoder_block_padding": (
        _module_error(jnn.DecoderBlock(8, 4, stride=2, padding=False, packed=True),
                      (1, 16, 8)),
        lambda: tnn.DecoderBlock(8, 4, 2, padding=False, packed=True)),
    "encoder_padding": (
        _module_error(JaxEncoder(8, (2, 4), 32, padding=False, packed=True), (1, 64, 1)),
        lambda: Encoder(8, (2, 4), 32, padding=False, packed=True)),
    "encoder_first_stride": (
        _module_error(JaxEncoder(8, (4, 2), 32, packed=True), (1, 64, 1)),
        lambda: Encoder(8, (4, 2), 32, packed=True)),
    "encoder_odd_length": (
        _module_error(JaxEncoder(8, (2, 4), 32, packed=True), (1, 63, 1)),
        lambda: Encoder(8, (2, 4), 32, packed=True)(torch.zeros(1, 1, 63))),
    "decoder_exclusive": (
        _module_error(JaxDecoder(16, 32, (4, 2), packed_blocks=1, packed_up_blocks=1),
                      (1, 4, 16)),
        lambda: Decoder(16, 32, (4, 2), packed_blocks=1, packed_up_blocks=1)),
    "decoder_padding": (
        _module_error(JaxDecoder(16, 32, (4, 2), padding=False, packed_blocks=1),
                      (1, 4, 16)),
        lambda: Decoder(16, 32, (4, 2), padding=False, packed_blocks=1)),
    "model_padding_free_encoder": (
        _model_error(JaxDAC(**TINY, padding=False, encoder_packed=True), (1, 1, 2048),
                     method=JaxDAC.encode),
        lambda: port.build_model(dataclasses.replace(PORT_TINY, encoder_packed=True),
                                 device="cpu").clone(padding=False)),
    "model_padding_free_decoder": (
        _model_error(JaxDAC(**TINY, padding=False, decoder_packed=1), (1, 1, 2048)),
        lambda: port.build_model(dataclasses.replace(PORT_TINY, decoder_packed=1),
                                 device="cpu").clone(padding=False)),
}


def _rngs(seed: int = 0):
    return {"params": jax.random.PRNGKey(seed), "vbr": jax.random.PRNGKey(seed + 1),
            "vbr_dropout": jax.random.PRNGKey(seed + 2)}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_every_jax_value_error_is_the_ports(case):
    """Each packing JAX refuses, the port refuses with ``ValueError`` and
    the same message; where the port refuses at construction, before the
    input length is known, the parenthesis after the message names what it
    knows."""
    jax_thunk, port_thunk = ERRORS[case]
    with pytest.raises(ValueError) as want:
        jax_thunk()
    with pytest.raises(ValueError) as got:
        port_thunk()
    assert str(got.value).split(" (got")[0] == str(want.value).split(" (got")[0]


# -------------------------------------------------------------- tiny model


@pytest.fixture(scope="module")
def tiny():
    """tests/test_packed.py's tiny model in both packages, seeded
    parameters, its input, and the unpacked model's encode in both."""
    jm = JaxDAC(**TINY)
    x = (np.random.RandomState(0).randn(2, 1, 2048) * 0.2).astype(np.float32)
    params = _seeded(jm, 10, _rngs(), jnp.asarray(x))
    tm = port.build_model(PORT_TINY, device="cpu", state_dict=state_dict_from_jax(params))
    return jm, jnp_tree(params), params, tm, x


def _near_ties(tm, *latents):
    """Frames (B, T') of a top-2 margin <= ``TIE_MARGIN`` in any of the
    given latents (B, D, T')."""
    with torch.inference_mode():
        w = rvq_kernel.stack_quantizer_weights(tm.quantizer)
        near = None
        for z in latents:
            z = torch.from_numpy(np.array(z)).transpose(1, 2)
            m = rvq_kernel.reference_margins(z.reshape(-1, z.shape[-1]), *w)
            tie = (m <= TIE_MARGIN).reshape(z.shape[:2]).numpy()
            near = tie if near is None else near | tie
    return near


def _encode_matches(jm, jp, tm, x):
    """The encode of ``jm`` and ``tm`` on ``x``: latents, imp_map within
    ``REL``; codes equal off near ties, masks equal."""
    jout, jz = jax.jit(lambda p, a: (
        jm.apply(p, a, level=1.0, method=type(jm).encode),
        jm.apply(p, a.transpose(0, 2, 1), method=lambda m, b: m.encoder(b))))(
        jp, jnp.asarray(x))
    with torch.inference_mode():
        tout = tm.encode(torch.from_numpy(x), level=1.0)
    _close(tout["latents"].numpy(), jout["latents"])
    _close(tout["imp_map"].numpy(), jout["imp_map"])
    np.testing.assert_array_equal(tout["mask_imp"].numpy(), np.asarray(jout["mask_imp"]))
    with torch.inference_mode():
        z = tm.encoder(torch.from_numpy(x))
    _close(z.numpy(), np.asarray(jz).transpose(0, 2, 1))
    near = _near_ties(tm, z.numpy(), np.asarray(jz).transpose(0, 2, 1))
    flipped = (tout["codes"].numpy() != np.asarray(jout["codes"])).any(axis=1)
    assert not (flipped & ~near).any()
    return tout


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_tiny_model_matches_jax(tiny, variant):
    """JAX's tiny model with each packing against the port's: the encode
    (encoder-packed) or the decode of the same z_q (decoder-packed)."""
    jm, jp, _, tm, x = tiny
    kw = VARIANTS[variant]
    jpm = dataclasses.replace(jm, **kw)
    tpm = port.build_model(dataclasses.replace(PORT_TINY, **kw), device="cpu",
                           state_dict=tm.state_dict())
    if "encoder_packed" in kw:
        _encode_matches(jpm, jp, tpm, x)
        return
    z_q = (np.random.RandomState(1).randn(2, 64, 64) * 0.5).astype(np.float32)
    want = jax.jit(lambda p, z: jpm.apply(p, z, method=JaxDAC.decode))(jp, jnp.asarray(z_q))
    with torch.inference_mode():
        got = tpm.decode(torch.from_numpy(z_q))
    _close(got.numpy(), want)


def test_packed_dac_moe_matches_jax():
    """A ``DAC_MOE`` with the packed encoder and decoder tail: encode at
    level 1 and decode of its z_q, against JAX's."""
    kw = dict(encoder_packed=True, decoder_packed=1)
    jm = JaxMOE(**TINY, level_min=1.0, level_max=1.0, **kw)
    x = (np.random.RandomState(2).randn(2, 1, 2048) * 0.2).astype(np.float32)
    params = _seeded(jm, 13, _rngs(3), jnp.asarray(x))
    tm = port.build_model(dataclasses.replace(PORT_TINY, **kw), device="cpu",
                          state_dict=state_dict_from_jax(params), model_class=DAC_MOE)
    assert tm.encoder.packed and tm.decoder.pack == 2
    jp = jnp_tree(params)
    tout = _encode_matches(jm, jp, tm, x)
    want = jax.jit(lambda p, z: jm.apply(p, z, method=JaxMOE.decode))(
        jp, jnp.asarray(tout["z_q"].numpy()))
    with torch.inference_mode():
        got = tm.decode(tout["z_q"])
    _close(got.numpy(), want)


@pytest.mark.parametrize("profile", [dict(encode_packed=True), dict(decode_packed=2),
                                     dict(decode_packed_up=1)],
                         ids=["encode_packed", "decode_packed_2", "decode_packed_up_1"])
def test_inference_profiles_pack_as_jax(tiny, profile):
    """``make_inference_model`` with a packing, folded float32 (so that only
    the layouts differ) against JAX's: the profile's fields, the forward's
    codes off near ties and its audio; the state dict's keys and shapes are
    the unpacked profile's, and JAX's folded packed tree loads into it."""
    jm, jp, _, tm, x = tiny
    kw = dict(decode_dtype=None, snake_approx=False)
    jfm, jfp = jfast.make_inference_model(jm, jp, **kw, **profile)
    tfm = fast.make_inference_model(tm, **kw, **profile)
    plain = fast.make_inference_model(tm, **kw)
    fields = {"encode_packed": "encoder_packed", "decode_packed": "decoder_packed",
              "decode_packed_up": "decoder_packed_up"}
    assert tfm.profile == dataclasses.replace(
        plain.profile, **{fields[k]: v for k, v in profile.items()})
    assert {k: v.shape for k, v in tfm.state_dict().items()} == {
        k: v.shape for k, v in plain.state_dict().items()}
    tfm.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jfp)),
                        strict=True)
    want = jax.jit(lambda p, a: jfm.apply(p, a, level=1.0))(jfp, jnp.asarray(x))
    with torch.inference_mode():
        got = tfm(torch.from_numpy(x), level=1.0)
    if "encode_packed" not in profile:
        np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    _close(got["audio"].numpy(), want["audio"], rel=1e-4)


def test_turbo_gate_runs_packed(tiny):
    """``turbo_gate(encode_packed=True)``: finite numbers (the JAX test's
    ask), and the serving profile is turbo + packed encoder."""
    tm = tiny[3]
    sm = fast.make_serving_model(tm, encode_packed=True)
    assert sm.profile.encoder_packed and sm.profile.encoder_snake_approx
    clips = fast.synthetic_probe(44100, 0)[:, :, :8192]
    res = fast.turbo_gate(tm, clips=clips, encode_packed=True)
    assert np.isfinite(res.mask_agreement) and 0.0 <= res.code_flip_rate <= 1.0
    assert len(res.clip_agreement_db) == 4


def test_state_dict_keys_unchanged_and_jax_tree_shared(tiny):
    """Every packed variant, live and folded, has the unpacked model's
    state-dict keys and shapes (the packed tensors are non-persistent
    buffers); JAX's packed model has the unpacked one's parameter tree."""
    jm, _, params, tm, x = tiny
    shapes = {k: v.shape for k, v in tm.state_dict().items()}
    for kw in (dict(encoder_packed=True, decoder_packed=2), dict(decoder_packed_up=2)):
        jtree = jax.eval_shape(dataclasses.replace(jm, **kw).init, _rngs(), jnp.zeros(x.shape))
        assert (jax.tree_util.tree_structure(jtree)
                == jax.tree_util.tree_structure(jax.tree_util.tree_map(jnp.asarray, params)))
        live = port.build_model(dataclasses.replace(PORT_TINY, **kw), device="cpu",
                                state_dict=state_dict_from_jax(params))
        assert {k: v.shape for k, v in live.state_dict().items()} == shapes
        assert not any(n.endswith("_packed") for n, _ in live.named_buffers())


def test_folded_packed_tensors_rebuilt_on_load(tiny):
    """A folded packed conv and Snake keep no packed tensor: they derive the
    packed kernel, bias and alpha from the parameters at each call, so a
    state dict loaded in place is what the next call computes with."""
    tm = tiny[3]
    fm = fast.make_inference_model(tm, decode_dtype=None, snake_approx=False,
                                   decode_packed=1)
    conv, snake_ = fm.decoder.out_conv, fm.decoder.snake
    assert not any(n.endswith("_packed") for n, _ in fm.named_buffers())
    x = torch.from_numpy(np.random.RandomState(5).randn(1, 2 * conv.w.shape[1], 32)
                         .astype(np.float32))

    def want(w, bias, alpha):
        kernel, lo, _ = tnn.pack_conv_kernel(w, dilation=1, stride=1, padding=3,
                                             pack_in=2, pack_out=2)
        return (F.conv1d(x, kernel, None, 1, lo) + bias.repeat(2).reshape(1, -1, 1),
                snake_plain(x, alpha.repeat(2), False))

    with torch.no_grad():
        for scale in (1.0, 2.0):
            if scale != 1.0:
                state = fm.state_dict()
                for key in ("decoder.out_conv.w", "decoder.out_conv.bias",
                            "decoder.snake.alpha"):
                    state[key] = scale * state[key]
                fm.load_state_dict(state)
            y, s_ = want(conv.w, conv.bias, snake_.alpha)
            assert torch.equal(conv(x), y)
            assert torch.equal(snake_(x), s_)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_packed_gradients_equal_unpacked(tiny, variant):
    """The packed live model is the unpacked one's function: the gradients
    of a loss of the encoder's latents and feature (encoder-packed) or of the
    decode (decoder-packed) with respect to the input and every parameter of
    that stack."""
    tm, x = tiny[3], tiny[4]
    kw = VARIANTS[variant]
    packed = port.build_model(dataclasses.replace(PORT_TINY, **kw), device="cpu",
                              state_dict=tm.state_dict())
    stack = "encoder" if "encoder_packed" in kw else "decoder"
    inp = (x if stack == "encoder"
           else (np.random.RandomState(4).randn(2, 64, 64) * 0.5).astype(np.float32))
    grads = []
    for model in (tm, packed):
        net = getattr(model, stack)
        a = torch.from_numpy(inp).requires_grad_(True)
        if stack == "encoder":
            z, feat = net(a, return_feat=True)
            loss = (z * z).mean() + feat.abs().mean()
        else:
            loss = (net(a) ** 2).mean()
        params = list(net.parameters())
        grads.append(torch.autograd.grad(loss, [a, *params]))
    for g_unpacked, g_packed in zip(*grads):
        _close(g_packed.numpy(), g_unpacked.numpy())
