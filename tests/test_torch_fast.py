"""The port's fast-inference profiles against its live model and against the
JAX package's (``vrvq_tpu/nn/fold.py``, ``vrvq_tpu/infer/fast.py``), at the
sizes of ``tests/test_fold.py`` (encoder 8, decoder 128, 4 codebooks of
32 x 4), on jittered JAX parameters.

Tolerances:
  * fold: the folded float32 profile gives the live port model's codes and
    audio bit for bit (eager PyTorch builds the same kernel tensor); against
    the JAX fold, codes bit-identical and audio within rtol 1e-3 / atol 1e-4
    (the tolerance of the port's other decode tests);
  * the polynomial Snake: within 1e-6 of JAX's ``snake_approx`` over
    |alpha x| <= 40 (both float32, the order of operations the same; XLA may
    contract a product into an FMA), its ``sin^2`` within 5e-7 of the exact
    one (the JAX docstring's 2.6e-7, with float32 rounding of the reduction);
  * the bfloat16 decoder: codes equal to the float32 profile's, decode
    agreement > 35 dB against the port's float32 decode, the polynomial
    decode > 60 dB against the exact one (the JAX bars, test_fold.py);
  * ``turbo_gate``: the exact profile's codes equal JAX's; the turbo codes
    equal JAX's off near ties (top-2 margin <= 1e-5 in either package's
    latents), masks equal; so the mask agreement equals JAX's, and the flip
    rate differs from JAX's by at most the near-tie frames' share of the
    kept stages (none: equal); ``agreement_db`` within 1 dB
    of JAX's (both decodes are bfloat16, and the two frameworks round the
    bfloat16 convs and Snake at other places; the flips set the figure);
    ``passed`` by the same rule.
"""

import dataclasses
import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.infer import fast as jfast
from vrvq_tpu.models import DAC_VRVQ as JaxDAC
from vrvq_tpu.ops.snake import snake_approx as jax_snake_approx
import vrvq_tpu_torch as port
from vrvq_tpu_torch import kernel_times
from vrvq_tpu_torch.convert import state_dict_from_jax
from vrvq_tpu_torch.infer import fast
from vrvq_tpu_torch.models.dac_vrvq import DAC_VRVQ, Profile
from vrvq_tpu_torch.ops import rvq_kernel, snake
from vrvq_tpu_torch.utils import counter
from layout_twin import ncl_twin
from tests.test_torch_support import jax_model_and_params, jnp_tree

SIZES = dict(encoder_dim=8, codebook_size=32)
RTOL, ATOL = 1e-3, 1e-4
TIE_MARGIN = 1e-5


@pytest.fixture(scope="module")
def pair():
    jm, params = jax_model_and_params(0, **SIZES)
    tm = port.build_model(port.small_config(**SIZES), device="cpu",
                          state_dict=state_dict_from_jax(params))
    return jm, params, tm


def _audio(seed, n=32768, batch=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(batch, 1, n) * 0.3).astype(np.float32)


def _snr(ref, est):
    ref, est = np.asarray(ref, np.float64), np.asarray(est, np.float64)
    return 10 * np.log10(np.sum(ref ** 2) / max(np.sum((ref - est) ** 2), 1e-30))


@pytest.mark.parametrize("padding", [True, False], ids=["padded", "padless"])
@pytest.mark.parametrize("fold_encoder", [False, True])
def test_folded_profile_bit_identical_to_live(pair, padding, fold_encoder):
    _, _, tm = pair
    live = tm.clone(padding=padding)
    folded = fast.make_inference_model(live, decode_dtype=None,
                                       snake_approx=False,
                                       fold_encoder=fold_encoder)
    assert folded.profile.decoder_folded and not hasattr(folded.decoder.in_conv, "v")
    assert (folded.quantizer.quantizers[0].codebook.data_ptr()
            == live.quantizer.quantizers[0].codebook.data_ptr())  # shared
    x = torch.from_numpy(_audio(1))
    with torch.inference_mode():
        a, b = live.encode(x, level=1.0), folded.encode(x, level=1.0)
        assert torch.equal(a["codes"], b["codes"])
        assert torch.equal(a["z_q"], b["z_q"])
        assert torch.equal(live.decode(a["z_q"]), folded.decode(a["z_q"]))


@pytest.mark.parametrize("padding", [True, False], ids=["padded", "padless"])
def test_folded_profile_matches_jax(pair, padding):
    """The port's fold against JAX's ``make_inference_model(decode_dtype=None,
    snake_approx=False)``, and the JAX folded tree loaded into the port's
    folded modules (``convert.state_dict_from_jax``)."""
    jm, params, tm = pair
    jm = jm.clone(padding=padding)
    jfm, jfp = jfast.make_inference_model(jm, jnp_tree(params),
                                          decode_dtype=None, snake_approx=False)
    x = _audio(2)
    jout = jfm.apply(jfp, jnp.asarray(x), level=1.0)
    folded = fast.make_inference_model(tm.clone(padding=padding),
                                       decode_dtype=None, snake_approx=False)
    from_jax = DAC_VRVQ(tm.config, padding=padding, profile=folded.profile)
    from_jax.load_state_dict(
        state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jfp)), strict=True)
    with torch.inference_mode():
        for m in (folded, from_jax.eval()):
            out = m(torch.from_numpy(x), level=1.0)
            np.testing.assert_array_equal(out["codes"].numpy(),
                                          np.asarray(jout["codes"]))
            np.testing.assert_allclose(out["audio"].numpy(),
                                       np.asarray(jout["audio"]),
                                       rtol=RTOL, atol=ATOL)


def test_bf16_folded_tree_loads_as_bf16(pair):
    jm, params, tm = pair
    _, jfp = jfast.make_inference_model(jm, jnp_tree(params))
    sd = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jfp))
    assert sd["decoder.in_conv.w"].dtype == torch.bfloat16
    assert sd["quantizer.imp_subnet.in_conv.v"].dtype == torch.float32
    model = fast.make_inference_model(tm)
    assert model.decoder.in_conv.w.dtype == torch.bfloat16
    assert model.decoder.block_0.snake.alpha.dtype == torch.float32
    assert model.encoder.in_conv.v.dtype == torch.float32
    # the same bfloat16 kernels from both folds, to one bfloat16 rounding
    # (the two sum ||v|| in another order)
    for key in ("decoder.in_conv.w", "decoder.block_1.up.w"):
        torch.testing.assert_close(model.state_dict()[key].float(),
                                   sd[key].float(), rtol=2 ** -7, atol=0)
    model.load_state_dict(sd, strict=True)


def test_snake_approx_reference_matches_jax():
    rng = np.random.RandomState(0)
    shape = (2, 96, 4096)
    alpha = rng.uniform(0.5, 2.0, shape[1]).astype(np.float32)
    # |alpha x| up to 40
    x = (rng.uniform(-1, 1, shape) * (40.0 / alpha[None, :, None])).astype(np.float32)
    got = snake.snake_approx_reference(torch.from_numpy(x),
                                       torch.from_numpy(alpha)).numpy()
    ref = np.asarray(jax_snake_approx(jnp.asarray(x.transpose(0, 2, 1)),
                                      jnp.asarray(alpha))).transpose(0, 2, 1)
    assert np.abs(got - ref).max() <= 1e-6
    u = torch.from_numpy(rng.uniform(-40, 40, 1 << 20).astype(np.float32))
    exact = torch.sin(u.double()) ** 2
    assert (snake.sin2_approx(u).double() - exact).abs().max() <= 5e-7


def test_snake_approx_reference_in_bf16_rounds_once():
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(1, 8, 300) * 3).astype(np.float32))
    alpha = torch.from_numpy(rng.uniform(0.5, 2, 8).astype(np.float32))
    xb = x.bfloat16()
    for fn in (snake.snake_reference, snake.snake_approx_reference):
        y = fn(xb, alpha)
        assert y.dtype == torch.bfloat16
        assert torch.equal(y, fn(xb.float(), alpha).bfloat16())


@pytest.fixture(scope="module")
def tiny():
    """The port on the JAX ``tests/test_fold.py`` model's sizes (encoder 8
    at rates 2/4/4, decoder 64 at rates 4/4/2, 4 codebooks of 64 x 4),
    where the JAX package holds its bfloat16 and polynomial bars."""
    sizes = dict(encoder_dim=8, encoder_rates=(2, 4, 4), decoder_dim=64,
                 decoder_rates=(4, 4, 2))
    _, params = jax_model_and_params(0, **sizes)
    return port.build_model(port.small_config(**sizes), device="cpu",
                            state_dict=state_dict_from_jax(params))


def test_bf16_decoder_quality(tiny):
    """The fast profile (bfloat16 folded decoder, polynomial Snake): codes of
    the float32 encoder, decode within bfloat16 rounding of float32."""
    tm = tiny
    fast_m = fast.make_inference_model(tm)
    f32 = fast.make_inference_model(tm, decode_dtype=None, snake_approx=False)
    x = torch.from_numpy(_audio(3))
    with torch.inference_mode():
        a, b = f32(x, level=1.0), fast_m(x, level=1.0)
    assert torch.equal(a["codes"], b["codes"])
    assert b["audio"].dtype == torch.float32
    assert _snr(a["audio"], b["audio"]) > 35.0


def test_snake_approx_decode_quality(tiny):
    tm = tiny
    exact = fast.make_inference_model(tm, decode_dtype=None, snake_approx=False)
    approx = fast.make_inference_model(tm, decode_dtype=None, snake_approx=True)
    x = torch.from_numpy(_audio(7))
    with torch.inference_mode():
        a, b = exact(x, level=1.0), approx(x, level=1.0)
    assert torch.equal(a["codes"], b["codes"])
    assert _snr(a["audio"], b["audio"]) > 60.0


def _layout_calls():
    return dict(counter("decoder"))


def test_bf16_decoder_runs_channels_last(tiny):
    """The fast profile's unpacked bfloat16 decoder takes the channels-last
    path (the layout counter) and decodes within the bfloat16 bar of the
    folded float32 decoder (``test_bf16_decoder_quality``'s 35 dB)."""
    fast_m = fast.make_inference_model(tiny)
    f32 = fast.make_inference_model(tiny, decode_dtype=None, snake_approx=False)
    assert fast_m.decoder.channels_last and not f32.decoder.channels_last
    x = torch.from_numpy(_audio(3))
    with torch.inference_mode():
        z = f32.encode(x)["z_q"]
        counter("decoder").clear()
        a = f32.decode(z)
        assert _layout_calls() == {"ncl": 1}
        with kernel_times.snake_census(fast_m, by_mode=True) as census:
            b = fast_m.decode(z)
    assert _layout_calls() == {"ncl": 1, "channels_last": 1}
    assert {m for m, _ in census} == {"snake_approx_bf16_cl"}
    assert b.dtype == torch.float32 and b.shape == a.shape
    assert _snr(a, b) > 35.0


@pytest.mark.parametrize("profile", [
    dict(decode_dtype=None),
    dict(decode_packed=1),
    dict(decode_packed_up=2),
    dict(encode_dtype=torch.bfloat16, decode_dtype=torch.float32),
    dict(encode_snake_approx=True, fold_encoder=True, decode_dtype=None),
], ids=["f32", "packed", "packed_up", "bf16_encoder", "folded_turbo_encoder"])
def test_other_stacks_keep_ncl(tiny, profile):
    """Float32 decoders, the time-packed bfloat16 decoders and every
    encoder keep (B, C, T): no conv of theirs is channels-last, no Snake
    runs in that layout and the layout counter stays at zero."""
    m = fast.make_inference_model(tiny, **profile)
    for stack in (m, tiny):
        assert not any(getattr(mod, "channels_last", False) for mod in stack.modules())
    counter("decoder").clear()
    with torch.inference_mode(), kernel_times.snake_census(m, by_mode=True) as census:
        m(torch.from_numpy(_audio(4)), level=1.0)
    assert _layout_calls() == {"ncl": 1}
    assert not any(mode.endswith("_cl") for mode, _ in census)


def test_fast_profile_state_dict_unchanged(tiny):
    """The channels-last decoder stores its folded kernels in another memory
    format only: the state dict's keys, shapes and dtypes are the fold's,
    its values equal, and it loads back into the profile, by copy and by
    assignment, and through a save."""
    m = fast.make_inference_model(tiny)
    folded = fast._folded(tiny.state_dict(), "decoder.", torch.bfloat16)
    sd = m.state_dict()
    assert list(sd) == list(folded)
    for key, value in sd.items():
        assert (value.shape, value.dtype) == (folded[key].shape, folded[key].dtype), key
        assert torch.equal(value, folded[key]), key
    assert not sd["decoder.in_conv.w"].is_contiguous()  # stored channels-last
    buf = io.BytesIO()
    torch.save(sd, buf)
    loaded = torch.load(io.BytesIO(buf.getvalue()))
    again = m.with_state(loaded)
    fresh = DAC_VRVQ(m.config, profile=m.profile)
    fresh.load_state_dict(folded)
    x = torch.from_numpy(_audio(6))
    with torch.inference_mode():
        ref = m(x, level=1.0)["audio"]
        for other in (again, fresh):
            assert other.decoder.in_conv.w.transpose(1, 2).is_contiguous()
            assert torch.equal(other(x, level=1.0)["audio"], ref)


@pytest.mark.parametrize("padding", [True, False], ids=["padded", "padless"])
def test_channels_last_decodes_as_ncl(tiny, padding):
    """A clone of the fast model (padding-free too: its crops are views of
    the channels-last tensors) decodes as the (B, C, T) computation of the
    same parameters, within the bfloat16 bar; the clone shares the
    parameters, already channels-last, with no copy."""
    m = fast.make_inference_model(tiny)
    clone = m.clone(padding=padding)
    assert clone.decoder.block_1.up.w.data_ptr() == m.decoder.block_1.up.w.data_ptr()
    twin = ncl_twin(clone)
    z = torch.randn(2, m.config.resolved_latent_dim, 40,
                    generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        got, want = clone.decode(z), twin.decode(z)
    assert got.shape == want.shape
    assert _snr(want, got) > 35.0


def test_serving_model_is_turbo_profile(pair):
    _, _, tm = pair
    sm = fast.make_serving_model(tm)
    # as JAX's make_inference_model, the profile sets the packing fields
    # (unpacked by default) whatever the config says
    assert sm.profile == Profile(
        decoder_folded=True, decoder_compute_dtype=torch.bfloat16,
        encoder_snake_approx=True, decoder_snake_approx=True,
        encoder_packed=False, decoder_packed=0, decoder_packed_up=0)
    for a, b in zip(tm.quantizer.parameters(), sm.quantizer.parameters()):
        assert a.data_ptr() == b.data_ptr()
    # the packed variants: the turbo profile with JAX's packing fields, on
    # the same quantizer tensors
    for packing, field in ((dict(encode_packed=True), dict(encoder_packed=True)),
                           (dict(decode_packed=1), dict(decoder_packed=1)),
                           (dict(decode_packed_up=1), dict(decoder_packed_up=1))):
        pm = fast.make_serving_model(tm, **packing)
        assert pm.profile == dataclasses.replace(sm.profile, **field)
        assert (pm.quantizer.quantizers[0].codebook.data_ptr()
                == tm.quantizer.quantizers[0].codebook.data_ptr())
    with pytest.raises(ValueError, match="live model"):
        fast.make_inference_model(sm)


def _encodes(jm, jp, tm, clips, jmaker, tmaker):
    """One profile's codes and masks in both packages on ``clips``, and its
    near-tie frames (B, T'): a top-2 margin <= ``TIE_MARGIN`` in the port's
    latents or in JAX's."""
    jmm, jmp = jmaker(jm, jp)
    x = jnp.asarray(clips)
    jout = jmm.apply(jmp, x, level=1.0, method=JaxDAC.encode)
    jz = jmm.apply(jmp, x.transpose(0, 2, 1), method=lambda m, a: m.encoder(a))
    tmm = tmaker(tm)
    with torch.inference_mode():
        codes, mask = fast.encode_codes(tmm, torch.from_numpy(clips), 1.0)
        z = tmm.encoder(torch.from_numpy(clips)).transpose(1, 2)
        w = rvq_kernel.stack_quantizer_weights(tmm.quantizer)
        near_tie = np.zeros(z.shape[:2], bool)
        for latents in (z, torch.from_numpy(np.array(jz))):
            margins = rvq_kernel.reference_margins(
                latents.reshape(-1, latents.shape[-1]), *w)
            near_tie |= (margins <= TIE_MARGIN).reshape(z.shape[:2]).numpy()
    return {"codes": codes.numpy(), "mask": mask.numpy(),
            "jax_codes": np.asarray(jout["codes"]),
            "jax_mask": np.asarray(jout["mask_imp"]), "near_tie": near_tie}


@pytest.fixture(scope="module")
def gates(pair):
    jm, params, tm = pair
    clips = _audio(5, n=22050, batch=3)
    jres = jfast.turbo_gate(jm, jnp_tree(params), clips=clips, level=1.0)
    tres = fast.turbo_gate(tm, clips=clips, level=1.0)
    encodes = {name: _encodes(jm, jnp_tree(params), tm, clips, jmaker, tmaker)
               for name, jmaker, tmaker in (
                   ("exact", jfast.make_inference_model, fast.make_inference_model),
                   ("turbo", jfast.make_serving_model, fast.make_serving_model))}
    return encodes, jres, tres


@pytest.mark.parametrize("profile", ["exact", "turbo"])
def test_turbo_gate_codes_match_jax(gates, profile):
    """Exact and turbo codes of both packages on the gate's clips: the exact
    ones equal, the turbo ones equal off near ties (of the port's turbo
    latents or JAX's), the masks equal."""
    e = gates[0][profile]
    np.testing.assert_array_equal(e["mask"], e["jax_mask"])
    flipped = (e["codes"] != e["jax_codes"]).any(axis=1)
    assert not (flipped & ~e["near_tie"]).any()
    if profile == "exact":
        assert not flipped.any()


def test_turbo_gate_matches_jax(gates):
    """The gate's fields against JAX's. The flip rate counts the stages both
    profiles' masks keep; the two packages' codes differ only on near-tie
    frames, so the rates differ by at most those frames' kept stages over
    all kept stages (equal when no frame is a near tie)."""
    encodes, jres, tres = gates
    assert tres.probe == jres.probe == "caller-supplied clips"
    assert tres.mask_agreement == jres.mask_agreement
    both = (encodes["exact"]["mask"] > 0) & (encodes["turbo"]["mask"] > 0)
    near_tie = encodes["exact"]["near_tie"] | encodes["turbo"]["near_tie"]
    slack = (both & near_tie[:, None, :]).sum() / both.sum()
    assert abs(tres.code_flip_rate - jres.code_flip_rate) <= slack, (
        tres.code_flip_rate, jres.code_flip_rate, int(near_tie.sum()))
    if np.isinf(jres.agreement_db):  # no flip: both decodes identical
        assert tres.agreement_db == jres.agreement_db
    else:
        assert abs(tres.agreement_db - jres.agreement_db) <= 1.0, (tres, jres)
    assert len(tres.clip_agreement_db) == len(jres.clip_agreement_db) == 3
    assert tres.passed == (tres.agreement_db >= tres.min_agreement_db
                           and tres.mask_agreement >= tres.min_mask_agreement)


def test_turbo_gate_threshold_and_fallback(pair):
    _, _, tm = pair
    res = fast.turbo_gate(tm, min_mask_agreement=1.5, probe_dir="no/such/dir")
    assert res.probe == "synthetic harmonics (4 clips, fallback)"
    assert not res.passed
    assert dataclasses.asdict(res)["min_mask_agreement"] == 1.5
