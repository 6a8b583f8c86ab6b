"""One GAN train step of the port against the JAX package's, from the same
parameters, batch and random draws.

The small configuration of ``tests/test_parity_grads.py`` (encoder 16 with
rates 2/4/8, decoder 128 with rates 8/4/2, 4 codebooks of 64 x 4) with
``quantizer_dropout 0.25`` and ``full_codebook_rate 0.25``, so a batch of 4
has 2 importance rows, 1 random-depth row and 1 full row; a discriminator
with MPD periods 2 and 3 and one MRD of 512. JAX initializes (jittered), the
port loads the converted trees. The level and depth draws are pinned: the
JAX samplers are monkeypatched inside the test, the port is handed the same
values. Bars: every loss and both grad norms within rtol 1e-4; per-leaf
gradients of both networks within 1e-3 relative L2 (the bar of
``tests/test_parity_grads.py``); the parameters after the update within
1e-4 relative L2. The optimizer chain alone, fed the same gradients as
optax, gives optax's parameters within 1e-6 relative L2 over 3 steps with
the schedule and a clip that triggers. And the val step.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.losses import L1Loss as JL1, MelSpectrogramLoss as JMel
from vrvq_tpu.losses import MultiScaleSTFTLoss as JSTFT
from vrvq_tpu.models import DAC_VRVQ as JaxDAC, Discriminator as JaxDisc
from vrvq_tpu.train import loop as jloop
from vrvq_tpu.train.schedule import exponential_lr as j_exponential_lr
from vrvq_tpu.train.state import TrainState as JState, make_optimizer as j_make_optimizer
import vrvq_tpu_torch as port
from vrvq_tpu_torch.convert import discriminator_state_dict_from_jax, state_dict_from_jax
from vrvq_tpu_torch.losses import L1Loss, MelSpectrogramLoss, MultiScaleSTFTLoss
from vrvq_tpu_torch.models.discriminator import Discriminator
from vrvq_tpu_torch.train import loop
from vrvq_tpu_torch.train.schedule import exponential_lr
from vrvq_tpu_torch.train.state import TrainState, make_optimizer
from tests.test_torch_support import jitter

torch.set_num_threads(1)

SMALL = dict(encoder_dim=16, encoder_rates=(2, 4, 8), decoder_dim=128,
             decoder_rates=(8, 4, 2), n_codebooks=4, codebook_size=64,
             codebook_dim=4, level_min=0.125, level_max=6.0,
             imp2mask_alpha=2.0, quantizer_dropout=0.25,
             full_codebook_rate=0.25)
PERIODS, FFTS = (2, 3), (512,)
LAMBDAS = {"mel/loss": 15.0, "adv/feat_loss": 2.0, "adv/gen_loss": 1.0,
           "vq/commitment_loss": 0.25, "vq/codebook_loss": 1.0,
           "vq/rate_loss": 2.0, "stft/loss": 1.0, "waveform/loss": 10.0}
LOSS_KW = dict(stft=dict(window_lengths=(512, 128)),
               mel=dict(n_mels=(40, 20), window_lengths=(512, 128),
                        mel_fmin=(0, 0), mel_fmax=(None, None), pow=1.0,
                        mag_weight=0.0))
BS = 4
U = np.array([0.13, 0.55, 0.92, 0.31], np.float32)
DEPTHS = np.array([2], np.int64)


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def _audio():
    clips = [port.synthetic_clip(0.14, 44100, s) for s in (17, 23, 31, 47)]
    return np.concatenate(clips, axis=0)


def pin_jax_draws(monkeypatch):
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


@pytest.fixture(scope="module")
def setup():
    jgen = JaxDAC(**SMALL, model_type="VBR", sample_rate=44100)
    jdisc = JaxDisc(periods=PERIODS, fft_sizes=FFTS)
    rngs = {"params": jax.random.PRNGKey(0), "vbr": jax.random.PRNGKey(1),
            "vbr_dropout": jax.random.PRNGKey(2)}
    gp = jax.jit(lambda r: jgen.init(r, jnp.zeros((1, 1, 2048)), level=1.0))(rngs)
    dp = jax.jit(lambda k: jdisc.init(k, jnp.zeros((1, 1, 4096))))(jax.random.PRNGKey(3))
    gp = jitter(jax.tree_util.tree_map(np.asarray, gp), 11)
    dp = jitter(jax.tree_util.tree_map(np.asarray, dp), 12)
    return jgen, jdisc, gp, dp


def _port_state(gp, dp):
    gen = port.DAC_VRVQ(port.small_config(**SMALL))
    gen.load_state_dict(state_dict_from_jax(gp), strict=True)
    disc = Discriminator(periods=PERIODS, fft_sizes=FFTS)
    disc.load_state_dict(discriminator_state_dict_from_jax(dp), strict=True)
    return TrainState(gen, disc,
                      make_optimizer(gen.parameters(), max_grad_norm=1e3),
                      make_optimizer(disc.parameters(), max_grad_norm=10.0))


def _losses(jax_side: bool):
    if jax_side:
        return (JSTFT(**LOSS_KW["stft"]), JMel(**LOSS_KW["mel"]), JL1())
    return (MultiScaleSTFTLoss(**LOSS_KW["stft"]),
            MelSpectrogramLoss(**LOSS_KW["mel"]), L1Loss())


def _clipped(grads, max_norm):
    norm = float(np.sqrt(sum(np.sum(np.square(g)) for g in grads.values())))
    if norm >= max_norm:
        return {k: (g / np.float32(norm)) * np.float32(max_norm)
                for k, g in grads.items()}, norm
    return grads, norm


@pytest.fixture(scope="module")
def step_pair(setup):
    """Both packages' step from the same state, draws pinned; the JAX
    gradients recomputed beside its step."""
    jgen, jdisc, gp, dp = setup
    mp = pytest.MonkeyPatch()
    pin_jax_draws(mp)
    try:
        x = _audio()
        xj = jnp.asarray(x)
        opt_g, opt_d = j_make_optimizer(max_grad_norm=1e3), j_make_optimizer(max_grad_norm=10.0)
        jgp = jax.tree_util.tree_map(jnp.asarray, gp)
        jdp = jax.tree_util.tree_map(jnp.asarray, dp)
        jstate = JState(step=jnp.zeros((), jnp.int32), gen_params=jgp, disc_params=jdp,
                        opt_g=opt_g.init(jgp), opt_d=opt_d.init(jdp))
        stft_l, mel_l, wave_l = _losses(True)
        step = jax.jit(jloop.make_train_step(jgen, jdisc, opt_g, opt_d, LAMBDAS,
                                             stft_l, mel_l, wave_l))
        rng = jax.random.PRNGKey(5)
        new_jstate, jmetrics = step(jstate, xj, rng)
        # the gradients the step took, recomputed by the loop's own pieces
        gen_forward = jloop._make_gen_forward(jgen, False)
        g_loss = jloop._make_g_loss(gen_forward, jdisc, LAMBDAS, stft_l, mel_l, wave_l)
        d_loss = jloop._make_d_loss(jdisc)

        @jax.jit
        def grads(gen_params, disc_params, new_disc_params):
            recons = jax.lax.stop_gradient(gen_forward(gen_params, xj, rng)["audio"])
            return (jax.grad(d_loss)(disc_params, recons, xj),
                    jax.grad(lambda p: g_loss(p, new_disc_params, xj, rng)[0])(gen_params))

        d_grads, g_grads = grads(jgp, jdp, new_jstate.disc_params)
    finally:
        mp.undo()

    state = _port_state(gp, dp)
    stft_t, mel_t, wave_t = _losses(False)
    train_step = loop.make_train_step(LAMBDAS, stft_t, mel_t, wave_t)
    levels = state.generator.quantizer.random_levels(torch.from_numpy(U))
    metrics = train_step(state, torch.from_numpy(x), levels=levels, depths=DEPTHS)
    return {"jax": (new_jstate, jmetrics, d_grads, g_grads), "port": (state, metrics)}


def test_step_losses_and_grad_norms_match_jax(step_pair):
    _, jmetrics, _, _ = step_pair["jax"]
    _, metrics = step_pair["port"]
    assert set(metrics) == set(jmetrics)
    for key, value in jmetrics.items():
        np.testing.assert_allclose(metrics[key].item(), float(value), rtol=1e-4,
                                   err_msg=key)
    assert all(np.isfinite(v.item()) for v in metrics.values())


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_step_gradients_match_jax(step_pair, net):
    _, _, d_grads, g_grads = step_pair["jax"]
    state, _ = step_pair["port"]
    if net == "generator":
        module, tree, max_norm = state.generator, state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, g_grads)), 1e3
    else:
        module, tree, max_norm = state.discriminator, discriminator_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, d_grads)), 10.0
    want, _ = _clipped({k: v.numpy() for k, v in tree.items()}, max_norm)
    for name, p in module.named_parameters():
        assert p.grad is not None, name
        assert _rel_l2(p.grad.numpy(), want[name]) <= 1e-3, name


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_step_updates_match_jax(step_pair, net):
    new_jstate, _, _, _ = step_pair["jax"]
    state, _ = step_pair["port"]
    if net == "generator":
        module = state.generator
        tree = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, new_jstate.gen_params))
    else:
        module = state.discriminator
        tree = discriminator_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, new_jstate.disc_params))
    assert state.step == int(new_jstate.step) == 1
    # Adam's first update is about lr * sign(g): where |g| is near eps the
    # 1e-3 gradient agreement above leaves the update ~1 % apart, ~1e-5 of
    # the parameter; a wrong update (a sign, a step of the schedule) would
    # be ~1e-3 of it
    for name, p in module.named_parameters():
        assert _rel_l2(p.detach().numpy(), tree[name].numpy()) <= 1e-4, name


def test_optimizer_chain_matches_optax():
    """3 updates of the same parameters from the same gradients, with a
    decaying schedule (gamma 0.9, warmup 2) and a clip (max norm 1.0) that
    triggers at the second step only."""
    rng = np.random.RandomState(0)
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 2, 4)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    scales = [0.05, 3.0, 0.02]  # global norms ~0.4, ~25, ~0.2
    grads = [{k: (s * rng.randn(*shapes[k])).astype(np.float32) for k in shapes}
             for s in scales]
    kw = dict(lr=1e-2, betas=(0.8, 0.99), weight_decay=1e-2, gamma=0.9, warmup=2,
              max_grad_norm=1.0)
    jopt = j_make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    topt = make_optimizer(tp.values(), **kw)
    norms = []
    for g in grads:
        updates, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jst, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        norms.append(float(topt.step()))
    assert norms[1] >= 1.0 > max(norms[0], norms[2])  # the clip triggered once
    for k in shapes:
        assert _rel_l2(tp[k].detach().numpy(), np.asarray(jp[k])) <= 1e-6, k
    assert topt.count == 3


def test_schedule_matches_jax():
    for warmup in (0, 3):
        ours, theirs = exponential_lr(1e-4, 0.999996, warmup), j_exponential_lr(1e-4, 0.999996, warmup)
        for step in (0, 1, 2, 3, 7, 250000):
            np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6)


def test_val_step_matches_jax(setup):
    jgen, _, gp, _ = setup
    x = _audio()
    stft_l, mel_l, wave_l = _losses(True)
    want = jax.jit(jloop.make_val_step(jgen, stft_l, mel_l, wave_l))(
        jax.tree_util.tree_map(jnp.asarray, gp), jnp.asarray(x))
    gen = port.DAC_VRVQ(port.small_config(**SMALL))
    gen.load_state_dict(state_dict_from_jax(gp), strict=True)
    got = loop.make_val_step(*_losses(False))(gen, torch.from_numpy(x))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].item(), float(want[key]), rtol=1e-4,
                                   err_msg=key)
