"""The rest of ``tests/test_torch_train_accum.py``'s tests (its docstring
states the configuration and the bars): the accumulated step with distinct
draws in each micro-batch, the split step, a batch that does not divide, the
step generator's draws per micro-batch, and ``detach_imp_map_input``'s
gradient. Their set-up is that file's and ``tests/test_torch_train_step.py``'s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.models import DAC_VRVQ as JaxDAC
from vrvq_tpu.train import loop as jloop
import vrvq_tpu_torch as port
from vrvq_tpu_torch.convert import state_dict_from_jax
from vrvq_tpu_torch.train import loop
from tests.test_torch_train_accum import (DISTINCT, _batch8, _compare, _jax_accumulated,
                                          _jax_state)
from tests.test_torch_train_step import (DEPTHS, LAMBDAS, SMALL, U, _audio, _losses,
                                         _port_state, _rel_l2, pin_jax_draws, setup)

torch.set_num_threads(1)


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
