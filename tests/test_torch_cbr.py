"""The port's CBR codec (``model_type: CBR``, ``conf/original_dac/cbr.yml``)
against the JAX package's, from the same jittered parameters.

Eval: codes bit-identical at ``n_quantizers`` 1, 2 and 4, z_q and audio
within atol 1e-5; ``from_codes`` and ``from_latents`` likewise. Training: one
GAN step with quantizer dropout 0.5 (a batch of 4: 2 rows at a drawn depth,
2 at every stage), the JAX sampler pinned inside the test and the port handed
the same depths: every loss and both grad norms within rtol 1e-4, every
gradient leaf within 1e-3 relative L2 (the bars of
``tests/test_torch_train_step.py``). Serving: ``CodecProcessor`` compress
of the CBR model gives the JAX package's codes, with and without the fused
quantizer, and the port's reference-layout loader takes JAX's
``export_torch_state_dict`` of a CBR tree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.audio import Signal as JaxSignal
from vrvq_tpu.infer.codec_api import CodecProcessor as JaxProcessor
from vrvq_tpu.models import DAC_VRVQ as JaxDAC, Discriminator as JaxDisc
from vrvq_tpu.train import loop as jloop
from vrvq_tpu.train.checkpoint import export_torch_state_dict
from vrvq_tpu.train.state import TrainState as JState, make_optimizer as j_make_optimizer
import vrvq_tpu_torch as port
from vrvq_tpu_torch.convert import (discriminator_state_dict_from_jax,
                                    state_dict_from_jax, state_dict_from_reference)
from vrvq_tpu_torch.models.discriminator import Discriminator
from vrvq_tpu_torch.train import loop
from vrvq_tpu_torch.train.state import TrainState, make_optimizer
from tests.test_torch_support import JAX_CFG, jitter, jnp_tree, own_loudness_meters
from tests.test_torch_train_step import (FFTS, LAMBDAS, PERIODS, SMALL, _audio,
                                         _clipped, _losses, _rel_l2)

torch.set_num_threads(1)

CBR = dict(model_type="CBR", quantizer_dropout=0.5)
BS = 4
DEPTHS = np.array([2, 3, 4, 1], np.int32)  # JAX draws one per row, keeps 2


@pytest.fixture(scope="module")
def pair():
    jm = JaxDAC(**{**JAX_CFG, **CBR})
    rngs = {"params": jax.random.PRNGKey(3), "vbr": jax.random.PRNGKey(4),
            "vbr_dropout": jax.random.PRNGKey(5)}
    params = jax.jit(lambda r: jm.init(r, jnp.zeros((1, 1, 4096))))(rngs)
    params = jitter(jax.tree_util.tree_map(np.asarray, params), 13)
    tm = port.build_model(port.small_config(**CBR), device="cpu",
                          state_dict=state_dict_from_jax(params))
    return jm, params, tm


def _clip_batch():
    return np.concatenate([port.synthetic_clip(0.3, 44100, s) for s in (5, 6)])


@pytest.mark.parametrize("nq", [1, 2, 4])
def test_cbr_codes_and_audio_match_jax(pair, nq):
    jm, params, tm = pair
    x = _clip_batch()
    jp = jnp_tree(params)
    want = jm.apply(jp, jnp.asarray(x), n_quantizers=nq)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), n_quantizers=nq)
    assert got["imp_map"] is None and got["mask_imp"] is None
    np.testing.assert_array_equal(got["codes"].numpy(), np.asarray(want["codes"]))
    assert got["codes"].shape[1] == nq
    np.testing.assert_allclose(got["z"].numpy(), np.asarray(want["z"]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["audio"].numpy(), np.asarray(want["audio"]),
                               rtol=0, atol=1e-5)


def test_from_codes_and_from_latents_match_jax(pair):
    jm, params, tm = pair
    x = tm.preprocess(torch.from_numpy(_clip_batch()))
    with torch.no_grad():
        enc = tm.encode(x)
        z_q = tm.quantizer.from_codes(enc["codes"])
        lz_q, lz_p, lcodes = tm.quantizer.from_latents(enc["latents"])
    jp = jnp_tree(params)
    codes = jnp.asarray(enc["codes"].numpy())
    jz_q, _, _ = jm.apply(jp, codes, method=lambda m, c: m.quantizer.from_codes(c))
    latents = jnp.asarray(enc["latents"].numpy().transpose(0, 2, 1))
    jlz_q, jlz_p, jlcodes = jm.apply(
        jp, latents, method=lambda m, z: m.quantizer.from_latents(z))
    np.testing.assert_allclose(z_q.numpy(), np.asarray(jz_q).transpose(0, 2, 1),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(lz_q.numpy(), np.asarray(jlz_q).transpose(0, 2, 1),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(lz_p.numpy(), np.asarray(jlz_p).transpose(0, 2, 1),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(lcodes.numpy(), np.asarray(jlcodes))
    np.testing.assert_array_equal(lcodes.numpy(), enc["codes"].numpy())
    torch.testing.assert_close(z_q, enc["z_q"], rtol=0, atol=1e-5)


def test_reference_layout_loads_a_cbr_tree(pair):
    _, params, tm = pair
    sd = state_dict_from_reference(export_torch_state_dict(params), tm)
    assert not any("imp_subnet" in k for k in sd)
    want = state_dict_from_jax(params)
    assert sd.keys() == want.keys()
    for k in sd:
        assert torch.equal(sd[k], want[k]), k
    vbr = port.DAC_VRVQ(port.small_config())
    with pytest.raises(KeyError, match="imp_subnet"):
        state_dict_from_reference(export_torch_state_dict(params), vbr)


@pytest.mark.parametrize("case", [dict(n_quantizers=2, win_duration=0.5),
                                  dict(n_quantizers=4, win_duration=None)],
                         ids=["chunked-nq2", "oneshot-nq4"])
def test_codec_processor_cbr_matches_jax(pair, case):
    own_loudness_meters()
    jm, params, tm = pair
    clip = port.synthetic_clip(1.3, 44100, 9)
    want = JaxProcessor(jm, jnp_tree(params)).compress(JaxSignal(clip, 44100), **case)
    for fused in (False, True):
        proc = port.CodecProcessor(tm, fused_quantizer=fused)
        dac = proc.compress(port.Signal(clip, 44100), **case)
        assert dac.vbr_counts is None and dac.padding == want.padding
        np.testing.assert_array_equal(dac.codes, np.asarray(want.codes))
        out = proc.decompress(dac)
        assert out.audio_data.shape == (1, 1, clip.shape[-1])
    with pytest.raises(ValueError, match="CBR"):
        proc.compress(port.Signal(clip, 44100), level=1.0)


def pin_jax_depths(monkeypatch):
    real_randint = jax.random.randint

    def randint(key, shape, *args, **kwargs):
        if tuple(shape) == (BS,):
            return jnp.asarray(DEPTHS)
        return real_randint(key, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, "randint", randint)


@pytest.fixture(scope="module")
def step_pair():
    small = {**SMALL, **CBR}
    jgen = JaxDAC(**small, sample_rate=44100)
    jdisc = JaxDisc(periods=PERIODS, fft_sizes=FFTS)
    rngs = {"params": jax.random.PRNGKey(0), "vbr": jax.random.PRNGKey(1),
            "vbr_dropout": jax.random.PRNGKey(2)}
    gp = jax.jit(lambda r: jgen.init(r, jnp.zeros((1, 1, 2048))))(rngs)
    dp = jax.jit(lambda k: jdisc.init(k, jnp.zeros((1, 1, 4096))))(jax.random.PRNGKey(3))
    gp = jitter(jax.tree_util.tree_map(np.asarray, gp), 21)
    dp = jitter(jax.tree_util.tree_map(np.asarray, dp), 22)
    x = _audio()
    mp = pytest.MonkeyPatch()
    pin_jax_depths(mp)
    try:
        opt_g, opt_d = j_make_optimizer(max_grad_norm=1e3), j_make_optimizer(max_grad_norm=10.0)
        jgp = jax.tree_util.tree_map(jnp.asarray, gp)
        jdp = jax.tree_util.tree_map(jnp.asarray, dp)
        jstate = JState(step=jnp.zeros((), jnp.int32), gen_params=jgp, disc_params=jdp,
                        opt_g=opt_g.init(jgp), opt_d=opt_d.init(jdp))
        stft_l, mel_l, wave_l = _losses(True)
        rng = jax.random.PRNGKey(5)
        _, jmetrics = jax.jit(jloop.make_train_step(
            jgen, jdisc, opt_g, opt_d, LAMBDAS, stft_l, mel_l, wave_l))(
                jstate, jnp.asarray(x), rng)
        gen_forward = jloop._make_gen_forward(jgen, False)
        g_loss = jloop._make_g_loss(gen_forward, jdisc, LAMBDAS, stft_l, mel_l, wave_l)
        d_loss = jloop._make_d_loss(jdisc)

        @jax.jit
        def grads(gen_params, disc_params):
            recons = jax.lax.stop_gradient(gen_forward(gen_params, jnp.asarray(x), rng)["audio"])
            d_grads = jax.grad(d_loss)(disc_params, recons, jnp.asarray(x))
            new_opt = opt_d.update(d_grads, opt_d.init(disc_params), disc_params)[0]
            new_disc = jax.tree_util.tree_map(lambda p, u: p + u, disc_params, new_opt)
            return d_grads, jax.grad(
                lambda p: g_loss(p, new_disc, jnp.asarray(x), rng)[0])(gen_params)

        d_grads, g_grads = grads(jgp, jdp)
    finally:
        mp.undo()

    gen = port.DAC_VRVQ(port.small_config(**small))
    gen.load_state_dict(state_dict_from_jax(gp), strict=True)
    disc = Discriminator(periods=PERIODS, fft_sizes=FFTS)
    disc.load_state_dict(discriminator_state_dict_from_jax(dp), strict=True)
    state = TrainState(gen, disc, make_optimizer(gen.parameters(), max_grad_norm=1e3),
                       make_optimizer(disc.parameters(), max_grad_norm=10.0))
    metrics = loop.make_train_step(LAMBDAS, *_losses(False))(
        state, torch.from_numpy(x), depths=DEPTHS[: int(BS * CBR["quantizer_dropout"])])
    return jmetrics, d_grads, g_grads, state, metrics


def test_cbr_step_losses_match_jax(step_pair):
    jmetrics, _, _, _, metrics = step_pair
    assert set(metrics) == set(jmetrics) and "vq/rate_loss" not in metrics
    for key, value in jmetrics.items():
        np.testing.assert_allclose(metrics[key].item(), float(value), rtol=1e-4,
                                   err_msg=key)


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_cbr_step_gradients_match_jax(step_pair, net):
    _, d_grads, g_grads, state, _ = step_pair
    if net == "generator":
        module, max_norm = state.generator, 1e3
        tree = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, g_grads))
    else:
        module, max_norm = state.discriminator, 10.0
        tree = discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, d_grads))
    want, _ = _clipped({k: v.numpy() for k, v in tree.items()}, max_norm)
    for name, p in module.named_parameters():
        assert p.grad is not None, name
        assert _rel_l2(p.grad.numpy(), want[name]) <= 1e-3, name
