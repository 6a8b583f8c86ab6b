"""The port's ``DAC_MOE`` (router-gated codec) against the JAX package's,
from the same jittered parameters, at a small size (encoder 8, decoder 64,
4 codebooks of 32 x 4).

Tolerances: ``generate_mask_ste_moe`` forward equal and its gradient within
1e-6 of ``jax.grad``; VBR encode at three levels, padded and padding-free
(the router's scores cropped to the latent frames): codes and masks
bit-identical, the router's ``imp_map`` and z_q within 1e-5; ``decode`` and
``decode_from_codes`` within 1e-4 of JAX's audio; CBR serving through
``CodecProcessor`` gives JAX's ``.dac`` codes exactly, one-shot and chunked;
the train forward with the draws pinned on both sides: losses within rtol
1e-5, every gradient leaf within 1e-3 relative L2 of ``jax.grad``'s (the
bars of ``tests/test_torch_train_step.py``).

And why the port refuses a VBR ``compress`` of a ``DAC_MOE``: the JAX
package's ``CodecProcessor`` turns the router's scores into counts with the
importance subnet's prefix rule, and its counts disagree with its own
model's mask (``test_jax_vbr_counts_disagree_with_the_model_mask``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.audio import Signal as JaxSignal
from vrvq_tpu.infer.codec_api import CodecProcessor as JaxProcessor
from vrvq_tpu.models import DAC_MOE as JaxMOE
from vrvq_tpu.native.io import wavio
from vrvq_tpu.ops import masks as jmasks
from vrvq_tpu.train.checkpoint import export_torch_state_dict
import vrvq_tpu_torch as port
from vrvq_tpu_torch.convert import state_dict_from_jax, state_dict_from_reference
from vrvq_tpu_torch.infer import streaming, sweep
from vrvq_tpu_torch.models.dac_moe import DAC_MOE
from vrvq_tpu_torch.ops import masks as tmasks
from tests.test_torch_support import jitter, jnp_tree

torch.set_num_threads(1)

SIZES = dict(encoder_dim=8, decoder_dim=64, n_codebooks=4, codebook_size=32,
             codebook_dim=4, level_min=0.5, level_max=2.0, imp2mask_alpha=2.0,
             full_codebook_rate=0.25, quantizer_dropout=0.25)
JAX_CFG = dict(encoder_rates=(2, 4, 8, 8), decoder_rates=(8, 8, 4, 2),
               sample_rate=44100, **SIZES)
LEVELS = (0.5, 1.0, 2.0)
BS = 4
U = np.array([0.13, 0.55, 0.92, 0.31], np.float32)  # the level draws
DEPTHS = np.array([2], np.int64)  # the one dropout row's depth


def _pair(seed, **overrides):
    jm = JaxMOE(**{**JAX_CFG, **overrides})
    rngs = {"params": jax.random.PRNGKey(seed), "vbr": jax.random.PRNGKey(seed + 1),
            "vbr_dropout": jax.random.PRNGKey(seed + 2)}
    params = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 1, 4096)), level=1.0))(rngs)
    params = jitter(jax.tree_util.tree_map(np.asarray, params), seed + 10)
    tm = port.build_model(port.small_config(**{**SIZES, **overrides}),
                          device="cpu", state_dict=state_dict_from_jax(params),
                          model_class=DAC_MOE)
    return jm, params, tm


@pytest.fixture(scope="module")
def pair():
    return _pair(0)


@pytest.fixture(scope="module")
def cbr_pair():
    return _pair(3, model_type="CBR")


def _audio(seed, n=16384, batch=2):
    return (np.random.RandomState(seed).randn(batch, 1, n) * 0.3).astype(np.float32)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_mask_ste_moe_matches_jax():
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 5, 11)).astype(np.float32)
    r = rng.randn(3, 5, 11).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    mask = tmasks.generate_mask_ste_moe(xt, 5, alpha=2.0)
    want = jmasks.generate_mask_ste_moe(jnp.asarray(x), 5, alpha=2.0)
    np.testing.assert_array_equal(mask.detach().numpy(), np.asarray(want))
    assert (mask[:, :2] == 1).all() and set(np.unique(mask.detach())) <= {0.0, 1.0}
    (mask * torch.from_numpy(r)).sum().backward()
    jgrad = jax.grad(lambda a: jnp.sum(jmasks.generate_mask_ste_moe(a, 5, 2.0)
                                       * jnp.asarray(r)))(jnp.asarray(x))
    assert xt.grad[:, 2:].abs().max() > 0 and (xt.grad[:, :2] == 0).all()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=0, atol=1e-6)


def test_model_surface_matches_jax(pair):
    """Parameter count, geometry (the router is no conv: ``vbr=False`` in
    the delay walk), and the variants keep the class."""
    jm, params, tm = pair
    n_jax = sum(np.asarray(v).size for v in jax.tree_util.tree_leaves(params))
    assert sum(p.numel() for p in tm.parameters()) == n_jax
    assert tm.delay == jm.delay and tm.hop_length == jm.hop_length
    assert tm.get_output_length(44100) == jm.get_output_length(44100)
    twin = tm.clone(padding=False)
    assert isinstance(twin, DAC_MOE) and not twin.padding
    assert not tm.prefix_mask and tm.uses_kernels()
    router = tm.quantizer.router.weight
    assert twin.quantizer.router.weight.data_ptr() == router.data_ptr()


@pytest.mark.parametrize("padding", [True, False], ids=["padded", "padless"])
@pytest.mark.parametrize("level", LEVELS)
def test_vbr_encode_matches_jax(pair, level, padding):
    jm, params, tm = pair
    jm, tm = jm.clone(padding=padding), tm.clone(padding=padding)
    x = _audio(1)
    want = jm.apply(jnp_tree(params), jnp.asarray(x), level=level,
                    method=JaxMOE.encode)
    with torch.inference_mode():
        got = tm.encode(torch.from_numpy(x), level=level)
    assert got["imp_map"].shape == (2, 4, got["codes"].shape[-1])
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    np.testing.assert_array_equal(got["mask_imp"].numpy(), np.asarray(want["mask_imp"]))
    np.testing.assert_allclose(got["imp_map"].numpy(), np.asarray(want["imp_map"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["z_q"].numpy(), np.asarray(want["z_q"]),
                               rtol=0, atol=1e-5)
    mask = got["mask_imp"].numpy()
    assert (mask[:, :2] == 1).all()


def test_masks_are_not_prefixes_and_grow_with_the_level(pair):
    """The router's mask keeps stages out of order somewhere (what counts
    cannot hold), and a higher level keeps at least as many stages."""
    _, _, tm = pair
    with torch.inference_mode():
        masks = [tm.encode(torch.from_numpy(_audio(2)), level=lv)["mask_imp"].numpy()
                 for lv in LEVELS]
    assert all((b >= a).all() for a, b in zip(masks, masks[1:]))
    holes = [(m[:, 1:] > m[:, :-1]).any() for m in masks]
    assert any(holes), "no frame keeps a stage after one it drops"


@pytest.mark.parametrize("padding", [True, False], ids=["padded", "padless"])
def test_decode_and_decode_from_codes_match_jax(pair, padding):
    jm, params, tm = pair
    jm, tm = jm.clone(padding=padding), tm.clone(padding=padding)
    jp = jnp_tree(params)
    x = _audio(3)
    enc = jm.apply(jp, jnp.asarray(x), level=1.0, method=JaxMOE.encode)
    want_zq = jm.apply(jp, enc["z_q"], method=JaxMOE.decode)
    want_codes = jm.apply(jp, enc["codes"], enc["mask_imp"],
                          method=JaxMOE.decode_from_codes)
    with torch.inference_mode():
        got = tm.encode(torch.from_numpy(x), level=1.0)
        audio_zq = tm.decode(got["z_q"]).numpy()
        audio_codes = tm.decode_from_codes(got["codes"], got["mask_imp"]).numpy()
    np.testing.assert_allclose(audio_zq, np.asarray(want_zq), rtol=0, atol=1e-4)
    np.testing.assert_allclose(audio_codes, np.asarray(want_codes), rtol=0, atol=1e-4)


@pytest.mark.parametrize("case", [dict(n_quantizers=2, win_duration=0.5),
                                  dict(n_quantizers=4, win_duration=None)],
                         ids=["chunked-nq2", "oneshot-nq4"])
@pytest.mark.parametrize("model_type", ["CBR", "VBR"])
def test_cbr_serving_matches_jax(pair, cbr_pair, model_type, case, monkeypatch):
    """CBR compress (a CBR ``DAC_MOE``, and a VBR one at ``n_quantizers``):
    JAX's ``.dac`` codes bit for bit; decompress within 1e-4 of JAX's."""
    monkeypatch.setattr(wavio, "available", lambda: False)  # one loudness meter
    jm, params, tm = cbr_pair if model_type == "CBR" else pair
    clip = port.synthetic_clip(1.3, 44100, 9)
    jproc = JaxProcessor(jm, jnp_tree(params))
    want = jproc.compress(JaxSignal(clip, 44100), **case)
    proc = port.CodecProcessor(tm)
    dac = proc.compress(port.Signal(clip, 44100), **case)
    assert dac.vbr_counts is None and dac.padding == want.padding
    np.testing.assert_array_equal(dac.codes, np.asarray(want.codes))
    np.testing.assert_allclose(proc.decompress(dac).audio_data,
                               np.asarray(jproc.decompress(want).audio_data),
                               rtol=0, atol=1e-4)


def test_vbr_serving_and_fused_quantizer_raise(pair):
    _, _, tm = pair
    sig = port.Signal(port.synthetic_clip(0.5, 44100, 1), 44100)
    proc = port.CodecProcessor(tm)
    with pytest.raises(NotImplementedError, match="prefix of the stages"):
        proc.compress(sig, level=1.0)
    for cls in (streaming.StreamingEncoder, streaming.StreamPool):
        with pytest.raises(NotImplementedError, match="vbr_counts"):
            cls(proc, win_duration=0.5, level=1.0)
        cls(proc, win_duration=0.5, n_quantizers=3)  # CBR streams
    with pytest.raises(NotImplementedError, match="prefix of the stages"):
        sweep.LevelSweep(tm)
    with pytest.raises(ValueError, match="DAC_VRVQ only"):
        port.CodecProcessor(tm, fused_quantizer=True)


def test_jax_vbr_counts_disagree_with_the_model_mask():
    """The JAX package's VBR compress of a DAC_MOE stores counts from the
    importance subnet's prefix rule (``vrvq_tpu/infer/codec_api.py:76-81``)
    applied to the router's scores, while the model masks them per stage at
    0.5 with two stages forced (``vrvq_tpu/models/dac_moe.py:112-114``): the
    counts code fewer stages than the model keeps. The port raises there."""
    jm = JaxMOE(encoder_dim=8, decoder_dim=64, n_codebooks=4, codebook_size=32,
                codebook_dim=4, model_type="VBR", level_min=1.0, level_max=1.0)
    rngs = {"params": jax.random.PRNGKey(0), "vbr": jax.random.PRNGKey(1),
            "vbr_dropout": jax.random.PRNGKey(2)}
    params = jm.init(rngs, jnp.zeros((1, 1, 4096)), level=1.0)
    # 1 s of seeded noise, whole frames, within [-1, 1] (compress leaves it)
    noise = np.clip(0.3 * np.random.RandomState(0).randn(1, 1, 86 * 512),
                    -1, 1).astype(np.float32)
    enc = jm.apply(params, jnp.asarray(noise), level=1.0, method=JaxMOE.encode)
    kept = np.asarray(enc["mask_imp"]).sum(axis=1)
    assert (kept >= 2).all()  # the two forced stages
    dac = JaxProcessor(jm, params).compress(JaxSignal(noise, 44100),
                                            win_duration=None, level=1.0,
                                            normalize_db=None)
    counts = np.asarray(dac.vbr_counts)
    assert counts.shape == kept.shape
    assert counts.mean() < kept.mean() and (counts < 2).any(), (
        counts.mean(), kept.mean())


def pinned_jax(monkeypatch):
    """Route the JAX level and depth draws to U and DEPTHS."""
    real_uniform, real_randint = jax.random.uniform, jax.random.randint

    def uniform(key, shape=(), *args, **kwargs):
        if tuple(shape) == (BS, 1, 1):
            dtype = args[0] if args else kwargs.get("dtype", jnp.float32)
            return jnp.asarray(U.reshape(BS, 1, 1), dtype)
        return real_uniform(key, shape, *args, **kwargs)

    def randint(key, shape, *args, **kwargs):
        if tuple(shape) == (len(DEPTHS), 1, 1):
            return jnp.asarray(DEPTHS.reshape(-1, 1, 1))
        return real_randint(key, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "randint", randint)


def test_train_forward_and_gradient_match_jax(pair, monkeypatch):
    """One train forward of a batch of 4 (2 router-masked rows, 1 at a
    drawn depth, 1 full) with the draws pinned: masks and codes equal, the
    losses within rtol 1e-5, and the gradient of audio, losses and scores
    on every parameter, the router's included, within 1e-3 relative L2."""
    jm, params, tm = pair
    x = _audio(5, n=8192, batch=BS)
    r = np.random.RandomState(6).randn(BS, 1, 8192).astype(np.float32)
    pinned_jax(monkeypatch)

    def jloss(p):
        out = jm.apply(p, jnp.asarray(x), train=True,
                       rngs={"vbr": jax.random.PRNGKey(7),
                             "vbr_dropout": jax.random.PRNGKey(8)})
        loss = (jnp.sum(out["audio"] * jnp.asarray(r)) + out["vq/commitment_loss"]
                + out["vq/codebook_loss"] + jnp.sum(out["imp_map"]))
        return loss, out

    (jl, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp_tree(params))
    model = tm.with_state(tm.state_dict()).train()
    levels = model.quantizer.random_levels(torch.from_numpy(U))
    out = model(torch.from_numpy(x), train=True, levels=levels, depths=DEPTHS)
    loss = ((out["audio"] * torch.from_numpy(r)).sum() + out["vq/commitment_loss"]
            + out["vq/codebook_loss"] + out["imp_map"].sum())
    loss.backward()
    np.testing.assert_array_equal(out["mask_imp"].detach().numpy(),
                                  np.asarray(jout["mask_imp"]))
    np.testing.assert_array_equal(out["codes"].numpy(), np.asarray(jout["codes"]))
    assert out["imp_map"].shape == (2, 4, out["codes"].shape[-1])
    for key in ("vq/commitment_loss", "vq/codebook_loss"):
        np.testing.assert_allclose(out[key].item(), float(jout[key]), rtol=1e-5)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrad))
    grads = dict(model.named_parameters())
    assert want.keys() == grads.keys()
    for key, g in want.items():
        got = grads[key].grad
        assert got is not None, key
        assert _rel_l2(got.numpy(), g.numpy()) <= 1e-3, key
    assert model.quantizer.router.weight.grad.abs().max() > 0


def test_router_conversion_from_jax_and_reference(pair):
    """The flax ``Dense`` kernel ``(in, Nq)`` becomes ``Linear.weight
    (Nq, in)``; the reference layout (JAX's ``export_torch_state_dict``)
    loads to the same tensors; ``init_params`` draws the router (seeded,
    zero bias, lecun-normal spread)."""
    _, params, tm = pair
    sd = state_dict_from_jax(params)
    router = params["params"]["quantizer"]["router"]
    np.testing.assert_array_equal(sd["quantizer.router.weight"].numpy(),
                                  np.asarray(router["kernel"]).T)
    np.testing.assert_array_equal(sd["quantizer.router.bias"].numpy(),
                                  np.asarray(router["bias"]))
    ref = export_torch_state_dict(params)
    assert "quantizer.router.weight" in ref
    from_ref = state_dict_from_reference(ref, tm)
    assert from_ref.keys() == sd.keys()
    for k in sd:
        assert torch.equal(from_ref[k], sd[k]), k
    vbr = port.DAC_VRVQ(tm.config)
    with pytest.raises(KeyError, match="imp_subnet"):
        state_dict_from_reference(ref, vbr)
    a = port.build_model(tm.config, device="cpu", seed=4, model_class=DAC_MOE)
    b = port.build_model(tm.config, device="cpu", seed=4, model_class=DAC_MOE)
    w = a.quantizer.router.weight
    assert torch.equal(w, b.quantizer.router.weight)
    assert (a.quantizer.router.bias == 0).all()
    std = 1.0 / np.sqrt(w.shape[1])
    assert w.abs().max() <= 2 * std / 0.8796 + 1e-6 and 0.5 * std < w.std() < 1.5 * std
