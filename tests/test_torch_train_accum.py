"""The accumulated and split GAN steps of the port against the JAX
package's, and ``detach_imp_map_input``.

The small configuration and losses of ``tests/test_torch_train_step.py``.
Accumulated (``grad_accum_steps`` 2 and 4 over a batch of 8), twice:
against JAX's ``make_accum_train_step``, whose scan traces one body over
the micro-batches, so its samplers, pinned inside the test, give every
micro-batch the same draws; and, with distinct draws for each micro-batch,
against the scan's arithmetic rebuilt from JAX's own loss bodies, one call
per micro-batch and phase. Split (``split_train_step``, JAX's
``make_split_train_steps``): the port's step is the same update (eager
PyTorch has no second program to split off). Bars: every loss and both
grad norms within rtol 1e-4, both networks' updated parameters within
1e-3 relative L2 and, with distinct draws, every gradient the update took
within 1e-3 relative L2. Then: a batch that does not divide raises, each
micro-batch draws from the step's generator, and with
``detach_imp_map_input`` the rate loss's gradient reaches the importance
subnet as in JAX and the encoder not at all.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vrvq_tpu.models import DAC_VRVQ as JaxDAC
from vrvq_tpu.train import loop as jloop
from vrvq_tpu.train.state import TrainState as JState, make_optimizer as j_make_optimizer
import vrvq_tpu_torch as port
from vrvq_tpu_torch.convert import discriminator_state_dict_from_jax, state_dict_from_jax
from vrvq_tpu_torch.train import loop
from tests.test_torch_train_step import (DEPTHS, LAMBDAS, SMALL, U, _audio, _clipped,
                                         _losses, _port_state, _rel_l2, pin_jax_draws,
                                         setup)

torch.set_num_threads(1)

BATCH = 8
MICRO_U = {4: np.array([0.21, 0.66, 0.08, 0.47], np.float32),
           2: np.array([0.37, 0.84], np.float32)}
MICRO_DEPTHS = {4: np.array([3], np.int64), 2: None}  # dropout rows: int(m / 4)
# accum -> each micro-batch's (uniforms, dropout depths), all distinct
DISTINCT = {
    2: [(np.array([0.21, 0.66, 0.08, 0.47], np.float32), np.array([3], np.int64)),
        (np.array([0.93, 0.12, 0.58, 0.35], np.float32), np.array([1], np.int64))],
    4: [(np.array([0.37, 0.84], np.float32), None),
        (np.array([0.05, 0.71], np.float32), None),
        (np.array([0.62, 0.19], np.float32), None),
        (np.array([0.44, 0.98], np.float32), None)],
}


def _batch8():
    return np.concatenate([port.synthetic_clip(0.14, 44100, s)
                           for s in (17, 23, 31, 47, 53, 59, 61, 67)])


def _pin_micro(monkeypatch, m):
    real_uniform, real_randint = jax.random.uniform, jax.random.randint

    def uniform(key, shape=(), *args, **kwargs):
        if tuple(shape) == (m, 1, 1):
            dtype = args[0] if args else kwargs.get("dtype", jnp.float32)
            return jnp.asarray(MICRO_U[m].reshape(m, 1, 1), dtype)
        return real_uniform(key, shape, *args, **kwargs)

    def randint(key, shape, *args, **kwargs):
        if MICRO_DEPTHS[m] is not None and tuple(shape) == (len(MICRO_DEPTHS[m]), 1, 1):
            return jnp.asarray(MICRO_DEPTHS[m].reshape(-1, 1, 1))
        return real_randint(key, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "randint", randint)


def _jax_state(gp, dp):
    opt_g, opt_d = j_make_optimizer(max_grad_norm=1e3), j_make_optimizer(max_grad_norm=10.0)
    jgp = jax.tree_util.tree_map(jnp.asarray, gp)
    jdp = jax.tree_util.tree_map(jnp.asarray, dp)
    return opt_g, opt_d, JState(step=jnp.zeros((), jnp.int32), gen_params=jgp,
                                disc_params=jdp, opt_g=opt_g.init(jgp),
                                opt_d=opt_d.init(jdp))


def _pin_traced(monkeypatch, drawn):
    """JAX's samplers return ``drawn["u"]`` and ``drawn["depths"]``, which
    a traced function sets from its arguments: one compiled program then
    takes each micro-batch's own draws."""
    real_uniform, real_randint = jax.random.uniform, jax.random.randint

    def uniform(key, shape=(), *args, **kwargs):
        u = drawn.get("u")
        if u is not None and tuple(shape) == (u.shape[0], 1, 1):
            dtype = args[0] if args else kwargs.get("dtype", jnp.float32)
            return u.reshape(shape).astype(dtype)
        return real_uniform(key, shape, *args, **kwargs)

    def randint(key, shape, *args, **kwargs):
        d = drawn.get("depths")
        if d is not None and tuple(shape) == (d.shape[0], 1, 1):
            return d.reshape(shape)
        return real_randint(key, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "randint", randint)


def _jax_accumulated(jgen, jdisc, gp, dp, x, micro_draws):
    """JAX's accumulated update with micro-batch i drawing
    ``micro_draws[i]`` in both phases: the scan bodies of
    ``make_accum_train_step`` (the same loss bodies, gradients summed in
    order and divided by the count), one call per micro-batch."""
    accum = len(micro_draws)
    opt_g, opt_d, jstate = _jax_state(gp, dp)
    stft_l, mel_l, wave_l = _losses(True)
    gen_forward = jloop._make_gen_forward(jgen, False)
    g_loss = jloop._make_g_loss(gen_forward, jdisc, LAMBDAS, stft_l, mel_l, wave_l)
    d_loss = jloop._make_d_loss(jdisc)
    drawn, rng = {}, jax.random.PRNGKey(5)

    @jax.jit
    def d_grad(gen_params, disc_params, audio, u, depths):
        drawn.update(u=u, depths=depths)
        recons = jax.lax.stop_gradient(gen_forward(gen_params, audio, rng)["audio"])
        return jax.value_and_grad(d_loss)(disc_params, recons, audio)

    @jax.jit
    def g_grad(gen_params, disc_params, audio, u, depths):
        drawn.update(u=u, depths=depths)
        (_, losses), grads = jax.value_and_grad(
            lambda p: g_loss(p, disc_params, audio, rng), has_aux=True)(gen_params)
        return losses, grads

    def mean(trees):
        acc = jax.tree_util.tree_map(jnp.zeros_like, trees[0])
        for tree in trees:
            acc = jax.tree_util.tree_map(jnp.add, acc, tree)
        return jax.tree_util.tree_map(lambda g: g / accum, acc)

    micro = jnp.asarray(x).reshape(accum, -1, *x.shape[1:])
    args = [(micro[i], jnp.asarray(u), None if d is None else jnp.asarray(d))
            for i, (u, d) in enumerate(micro_draws)]
    mp = pytest.MonkeyPatch()
    _pin_traced(mp, drawn)
    try:
        d_out = [d_grad(jstate.gen_params, jstate.disc_params, *a) for a in args]
        d_grads = mean([g for _, g in d_out])
        d_updates, _ = opt_d.update(d_grads, jstate.opt_d, jstate.disc_params)
        new_dp = optax.apply_updates(jstate.disc_params, d_updates)
        g_out = [g_grad(jstate.gen_params, new_dp, *a) for a in args]
    finally:
        mp.undo()
    g_grads = mean([g for _, g in g_out])
    g_updates, _ = opt_g.update(g_grads, jstate.opt_g, jstate.gen_params)
    new_gp = optax.apply_updates(jstate.gen_params, g_updates)
    metrics = mean([losses for losses, _ in g_out])
    metrics.update({"adv/disc_loss": np.mean([float(l) for l, _ in d_out]),
                    "other/grad_norm_d": optax.global_norm(d_grads),
                    "other/grad_norm_g": optax.global_norm(g_grads)})
    return jstate.replace(step=jstate.step + 1, gen_params=new_gp,
                          disc_params=new_dp), metrics, (g_grads, d_grads)


def _compare(jstate, jmetrics, state, metrics, jgrads=None):
    """Losses and grad norms within rtol 1e-4, each updated parameter
    within 1e-3 relative L2. With ``jgrads`` (JAX's mean gradients of both
    networks), each gradient the optimizer took within 1e-3 relative L2:
    the update's direction. The change (new minus old) is not compared
    element by element: Adam's first step is about lr * sign(g), so an
    element whose gradient is within float32 noise of zero (|g| ~1e-5 of
    its leaf's RMS) takes a step of the other sign, which alone moves a
    256-element leaf's change ~0.1 relative L2."""
    assert set(jmetrics) <= set(metrics)
    for key in jmetrics:
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]),
                                   rtol=1e-4, err_msg=key)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    nets = [(state.generator, state_dict_from_jax, jstate.gen_params, 1e3),
            (state.discriminator, discriminator_state_dict_from_jax, jstate.disc_params,
             10.0)]
    for i, (module, to_torch, new, max_norm) in enumerate(nets):
        new = to_torch(as_np(new))
        if jgrads is not None:
            want, _ = _clipped({k: v.numpy() for k, v in to_torch(as_np(jgrads[i])).items()},
                               max_norm)
        for name, p in module.named_parameters():
            assert _rel_l2(p.detach().numpy(), new[name].numpy()) <= 1e-3, name
            if jgrads is not None:
                assert _rel_l2(p.grad.numpy(), want[name]) <= 1e-3, name
    assert state.step == int(jstate.step) == 1


@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_step_matches_jax(setup, accum):
    jgen, jdisc, gp, dp = setup
    m = BATCH // accum
    x = _batch8()
    mp = pytest.MonkeyPatch()
    _pin_micro(mp, m)
    try:
        opt_g, opt_d, jstate = _jax_state(gp, dp)
        step = jax.jit(jloop.make_accum_train_step(
            jgen, jdisc, opt_g, opt_d, LAMBDAS, *_losses(True), accum_steps=accum))
        new_jstate, jmetrics = step(jstate, jnp.asarray(x), jax.random.PRNGKey(5))
    finally:
        mp.undo()
    state = _port_state(gp, dp)
    levels = state.generator.quantizer.random_levels(torch.from_numpy(MICRO_U[m]))
    depths = MICRO_DEPTHS[m]
    train_step = loop.make_train_step(LAMBDAS, *_losses(False), accum_steps=accum)
    metrics = train_step(state, torch.from_numpy(x), levels=[levels] * accum,
                         depths=[depths] * accum)
    assert metrics["other/batch_size"].item() == BATCH
    _compare(new_jstate, jmetrics, state, metrics)


@pytest.mark.parametrize("accum", [2, 4])
def test_accumulated_step_with_distinct_draws_matches_jax(setup, accum):
    """Each micro-batch draws its own levels and depths, and the generator
    phase reuses the discriminator phase's draws micro-batch by
    micro-batch, as JAX's scan over the split rngs does."""
    jgen, jdisc, gp, dp = setup
    x = _batch8()
    new_jstate, jmetrics, jgrads = _jax_accumulated(jgen, jdisc, gp, dp, x,
                                                    DISTINCT[accum])
    state = _port_state(gp, dp)
    quantizer = state.generator.quantizer
    metrics = loop.make_train_step(LAMBDAS, *_losses(False), accum_steps=accum)(
        state, torch.from_numpy(x),
        levels=[quantizer.random_levels(torch.from_numpy(u)) for u, _ in DISTINCT[accum]],
        depths=[d for _, d in DISTINCT[accum]])
    _compare(new_jstate, jmetrics, state, metrics, jgrads)


def test_split_step_matches_jax(setup):
    """JAX's two programs (discriminator step, then generator step, the same
    rng) against the port's one step."""
    jgen, jdisc, gp, dp = setup
    x = _audio()
    mp = pytest.MonkeyPatch()
    pin_jax_draws(mp)
    try:
        opt_g, opt_d, jstate = _jax_state(gp, dp)
        d_step, g_step = jloop.make_split_train_steps(
            jgen, jdisc, opt_g, opt_d, LAMBDAS, *_losses(True))
        rng = jax.random.PRNGKey(5)
        jstate, m_d = jax.jit(d_step)(jstate, jnp.asarray(x), rng)
        jstate, jmetrics = jax.jit(g_step)(jstate, jnp.asarray(x), rng)
        jmetrics.update(m_d)
    finally:
        mp.undo()
    state = _port_state(gp, dp)
    levels = state.generator.quantizer.random_levels(torch.from_numpy(U))
    metrics = loop.make_train_step(LAMBDAS, *_losses(False))(
        state, torch.from_numpy(x), levels=levels, depths=DEPTHS)
    _compare(jstate, jmetrics, state, metrics)


def test_batch_that_does_not_divide_raises(setup):
    state = _port_state(*setup[2:])
    step = loop.make_train_step(LAMBDAS, *_losses(False), accum_steps=3)
    with pytest.raises(ValueError, match="not divisible by grad_accum_steps=3"):
        step(state, torch.from_numpy(_audio()))
    assert state.step == 0


def test_each_micro_batch_draws_from_the_step_generator(setup):
    state = _port_state(*setup[2:])
    calls = []
    real = state.generator.draws

    def draws(batch, generator, device):
        calls.append((batch, generator))
        return real(batch, generator, device)

    state.generator.draws = draws
    gen = torch.Generator().manual_seed(3)
    loop.make_train_step(LAMBDAS, *_losses(False), accum_steps=2)(
        state, torch.from_numpy(_audio()), generator=gen)
    assert calls == [(2, gen), (2, gen)]


@pytest.mark.parametrize("detach", [True, False], ids=["detach", "attached"])
def test_detach_imp_map_input_gradient(setup, detach):
    """The rate loss ``mean(imp_map)`` of a train forward: its gradient on
    the importance subnet equals JAX's (1e-3 relative L2 a leaf); the
    encoder's is zero with the detach and not without it."""
    _, _, gp, _ = setup
    small = {**SMALL, "detach_imp_map_input": detach}
    jgen = JaxDAC(**small, model_type="VBR", sample_rate=44100)
    x = _audio()
    rngs = {"vbr": jax.random.PRNGKey(1), "vbr_dropout": jax.random.PRNGKey(2)}
    jgrads = jax.jit(jax.grad(lambda p: jnp.mean(jgen.apply(
        p, jnp.asarray(x), train=True, rngs=rngs)["imp_map"])))(
            jax.tree_util.tree_map(jnp.asarray, gp))
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))

    gen = port.DAC_VRVQ(port.small_config(**small))
    gen.load_state_dict(state_dict_from_jax(gp), strict=True)
    out = gen(torch.from_numpy(x), train=True, generator=torch.Generator().manual_seed(0))
    torch.mean(out["imp_map"]).backward()
    for name, p in gen.named_parameters():
        if name.startswith("quantizer.imp_subnet."):
            assert _rel_l2(p.grad.numpy(), want[name].numpy()) <= 1e-3, name
    encoder = [p.grad for n, p in gen.named_parameters() if n.startswith("encoder.")]
    moved = sum(int(torch.count_nonzero(g)) for g in encoder if g is not None)
    assert (moved == 0) == detach, moved
