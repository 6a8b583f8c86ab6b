"""``remat``: the port's train step with the generator's forward recomputed
in its backward (``torch.utils.checkpoint``, non-reentrant), against the
plain step and against the JAX package's ``remat`` step (``jax.checkpoint``).

The small configuration of ``tests/test_torch_dist_support.py`` on a batch of
4 with pinned draws. Bars: on the CPU the remat step gives the plain step's
losses, gradients and parameters bit for bit (one step, and an accumulated
step of 2 micro-batches); against JAX's remat step every loss within rtol
1e-4 (``tests/test_train_step.py::test_remat_train_step_matches``) and each
updated parameter within 1e-3 relative L2; with the step's generator the
remat step takes the draws it would take pinned (the recompute must not
draw again).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.train import loop as jloop
import vrvq_tpu_torch as port
from vrvq_tpu_torch.convert import discriminator_state_dict_from_jax, state_dict_from_jax
from vrvq_tpu_torch.train import loop
from tests import test_torch_dist_support as support
from tests.test_torch_ddp import (_case, _jax_state, _rel_l2, jax_losses,
                                  pin_jax_draws, setup)

torch.set_num_threads(1)


@pytest.mark.parametrize("accum", [1, 2])
def test_remat_step_equals_plain_step_bit_for_bit(setup, accum):
    _, _, gp, dp = setup
    case = _case(gp, dp, 4 * accum, accum)
    plain = support.run_steps(case, accum=accum)
    remat = support.run_steps(case, accum=accum, remat=True)
    assert remat["metrics"] == plain["metrics"]
    support.same_bits(remat["params"], plain["params"])
    support.same_bits(remat["grads"], plain["grads"])


def test_remat_step_matches_jax_remat_step(setup):
    jgen, jdisc, gp, dp = setup
    case = _case(gp, dp, 4, 1)
    opt_g, opt_d, jstate = _jax_state(gp, dp)
    step = jax.jit(jloop.make_train_step(jgen, jdisc, opt_g, opt_d, support.LAMBDAS,
                                         *jax_losses(), remat=True))
    mp = pytest.MonkeyPatch()
    pin_jax_draws(mp)
    try:
        new, jmetrics = step(jstate, jnp.asarray(case["audio"]), jax.random.PRNGKey(5))
    finally:
        mp.undo()
    out = support.run_steps(case, remat=True)
    assert set(out["metrics"][0]) == set(jmetrics)
    for key, value in jmetrics.items():
        np.testing.assert_allclose(out["metrics"][0][key], float(value), rtol=1e-4,
                                   err_msg=key)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    for net, want in (("generator", state_dict_from_jax(as_np(new.gen_params))),
                      ("discriminator",
                       discriminator_state_dict_from_jax(as_np(new.disc_params)))):
        for name, p in out["params"][net].items():
            assert _rel_l2(p.numpy(), want[name].numpy()) <= 1e-3, (net, name)


def test_remat_with_the_step_generator_takes_the_pinned_draws(setup):
    """The step draws the levels and depths before the checkpointed
    forward: from a generator they are the draws ``draws()`` gives, and the
    recompute sees the same (a second draw would give other levels)."""
    _, _, gp, dp = setup
    case = _case(gp, dp, 4, 1)
    drawn = port.DAC_VRVQ(port.small_config(**support.MINI)).draws(
        4, torch.Generator().manual_seed(7), torch.device("cpu"))
    pinned = support.run_steps({**case, **drawn}, remat=True)

    state = support.train_state(case["gen"], case["disc"])
    step = loop.make_train_step(support.LAMBDAS, *support.losses(), remat=True)
    metrics = step(state, torch.from_numpy(case["audio"]),
                   generator=torch.Generator().manual_seed(7))
    assert {k: v.item() for k, v in metrics.items()} == pinned["metrics"][0]
    support.same_bits({net: {n: p.detach() for n, p in m.named_parameters()}
                for net, m in (("generator", state.generator),
                               ("discriminator", state.discriminator))},
               pinned["params"])
