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

This file holds the shared set-up and the accumulated step with the same
draws in every micro-batch; ``tests/test_torch_train_accum_rest.py`` holds
the other tests (two files, so that the suite's workers can take them at
once).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from vrvq_tpu.train import loop as jloop
from vrvq_tpu.train.state import TrainState as JState, make_optimizer as j_make_optimizer
import vrvq_tpu_torch as port
from vrvq_tpu_torch.convert import discriminator_state_dict_from_jax, state_dict_from_jax
from vrvq_tpu_torch.train import loop
from tests.test_torch_train_step import (LAMBDAS, _clipped, _losses, _port_state,
                                         _rel_l2, setup)

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
