"""The port's data-parallel GAN step on the CPU: ranks of a gloo process
group, each in a process of its own (``parallel.spawn``), against
the JAX package's step jitted over a 2-device ``data`` mesh and against the
port's single-process step on the global batch.

The small configuration of ``tests/test_torch_dist_support.py`` (two encoder
and two decoder blocks, 4 codebooks of 32 x 4, ``quantizer_dropout`` and
``full_codebook_rate`` 0.25; MPD 2, one MRD of 256) on a global batch of 4
(2 rows a rank: rank 0 holds the 2 importance rows, rank 1 the dropout and
the full row and no importance row); K = 2: ``tests/test_torch_ddp_accum.py``.
JAX initializes (jittered), the port loads the converted trees; the draws of
the global batch are pinned, the JAX samplers monkeypatched inside the test.
Bars: every loss and both grad norms within rtol 1e-4; each gradient the
update took within 1e-3 relative L2 of JAX's (clipped); each updated
parameter within 1e-3 relative L2 (the bars of
``tests/test_torch_train_accum.py``); the ranks' parameters bit-identical.
ZeRO and the trainer over two ranks: ``tests/test_torch_ddp_trainer.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.losses import L1Loss as JL1, MelSpectrogramLoss as JMel
from vrvq_tpu.losses import MultiScaleSTFTLoss as JSTFT
from vrvq_tpu.models import DAC_VRVQ as JaxDAC, Discriminator as JaxDisc
from vrvq_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from vrvq_tpu.train import loop as jloop
from vrvq_tpu.train.state import TrainState as JState, make_optimizer as j_make_optimizer
import vrvq_tpu_torch as port
from vrvq_tpu_torch.convert import discriminator_state_dict_from_jax, state_dict_from_jax
from vrvq_tpu_torch.parallel import dist as pdist
from tests import test_torch_dist_support as support
from tests.test_torch_support import jitter

torch.set_num_threads(1)

U = np.array([0.13, 0.55, 0.92, 0.31], np.float32)  # a batch (micro-batch) of 4
DEPTHS = np.array([2], np.int64)  # its one dropout row


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b))
                 / max(np.linalg.norm(np.asarray(b)), 1e-30))


def pin_jax_draws(monkeypatch):
    real_uniform, real_randint = jax.random.uniform, jax.random.randint

    def uniform(key, shape=(), *args, **kwargs):
        if tuple(shape) == (len(U), 1, 1):
            dtype = args[0] if args else kwargs.get("dtype", jnp.float32)
            return jnp.asarray(U.reshape(-1, 1, 1), dtype)
        return real_uniform(key, shape, *args, **kwargs)

    def randint(key, shape, *args, **kwargs):
        if tuple(shape) == (len(DEPTHS), 1, 1):
            return jnp.asarray(DEPTHS.reshape(-1, 1, 1))
        return real_randint(key, shape, *args, **kwargs)

    monkeypatch.setattr(jax.random, "uniform", uniform)
    monkeypatch.setattr(jax.random, "randint", randint)


def jax_losses():
    return (JSTFT(**support.LOSS_KW["stft"]), JMel(**support.LOSS_KW["mel"]), JL1())


@pytest.fixture(scope="module")
def setup():
    jgen = JaxDAC(**support.MINI, model_type="VBR", sample_rate=44100)
    jdisc = JaxDisc(periods=support.PERIODS, fft_sizes=support.FFTS)
    rngs = {"params": jax.random.PRNGKey(0), "vbr": jax.random.PRNGKey(1),
            "vbr_dropout": jax.random.PRNGKey(2)}
    gp = jax.jit(lambda r: jgen.init(r, jnp.zeros((1, 1, 2048)), level=1.0))(rngs)
    dp = jax.jit(lambda k: jdisc.init(k, jnp.zeros((1, 1, 4096))))(jax.random.PRNGKey(3))
    gp = jitter(jax.tree_util.tree_map(np.asarray, gp), 11)
    dp = jitter(jax.tree_util.tree_map(np.asarray, dp), 12)
    return jgen, jdisc, gp, dp


def _case(gp, dp, batch, accum):
    levels = port.DAC_VRVQ(port.small_config(**support.MINI)).quantizer.random_levels(
        torch.from_numpy(U))
    case = {"gen": state_dict_from_jax(gp), "disc": discriminator_state_dict_from_jax(dp),
            "audio": support.audio(batch)}
    if accum == 1:
        return {**case, "levels": levels, "depths": DEPTHS}
    return {**case, "levels": [levels] * accum, "depths": [DEPTHS] * accum}


def _jax_state(gp, dp):
    opt_g, opt_d = j_make_optimizer(max_grad_norm=1e3), j_make_optimizer(max_grad_norm=10.0)
    jgp = jax.tree_util.tree_map(jnp.asarray, gp)
    jdp = jax.tree_util.tree_map(jnp.asarray, dp)
    return opt_g, opt_d, JState(step=jnp.zeros((), jnp.int32), gen_params=jgp,
                                disc_params=jdp, opt_g=opt_g.init(jgp),
                                opt_d=opt_d.init(jdp))


def _jax_mesh_step(jgen, jdisc, gp, dp, x, accum):
    """JAX's step (accumulated over ``accum`` micro-batches) jitted over a
    2-device mesh, the batch sharded, the state replicated; and its
    gradients of both networks, recomputed by the loop's own pieces on the
    whole batch."""
    opt_g, opt_d, jstate = _jax_state(gp, dp)
    stft_l, mel_l, wave_l = jax_losses()
    mesh = make_mesh(2)
    if accum == 1:
        step = jloop.make_train_step(jgen, jdisc, opt_g, opt_d, support.LAMBDAS,
                                     stft_l, mel_l, wave_l)
    else:
        step = jloop.make_accum_train_step(jgen, jdisc, opt_g, opt_d, support.LAMBDAS,
                                           stft_l, mel_l, wave_l, accum_steps=accum)
    rng = jax.random.PRNGKey(5)
    mp = pytest.MonkeyPatch()
    pin_jax_draws(mp)
    try:
        new, metrics = jax.jit(step)(replicate(jstate, mesh),
                                     shard_batch(jnp.asarray(x), mesh), rng)
        grads = None
        if accum == 1:
            gen_forward = jloop._make_gen_forward(jgen, False)
            g_loss = jloop._make_g_loss(gen_forward, jdisc, support.LAMBDAS,
                                        stft_l, mel_l, wave_l)
            d_loss = jloop._make_d_loss(jdisc)
            xj = jnp.asarray(x)

            @jax.jit
            def both(gen_params, disc_params, new_disc_params):
                recons = jax.lax.stop_gradient(gen_forward(gen_params, xj, rng)["audio"])
                return (jax.grad(lambda p: g_loss(p, new_disc_params, xj, rng)[0])(
                    gen_params), jax.grad(d_loss)(disc_params, recons, xj))

            grads = both(jstate.gen_params, jstate.disc_params, new.disc_params)
    finally:
        mp.undo()
    return new, metrics, grads


def _clipped(grads, max_norm):
    norm = float(np.sqrt(sum(np.sum(np.square(g)) for g in grads.values())))
    if norm >= max_norm:
        return {k: (g / np.float32(norm)) * np.float32(max_norm) for k, g in grads.items()}
    return grads


def _compare_with_jax(ranks, new, jmetrics, jgrads):
    for out in ranks:
        metrics = out["metrics"][-1]
        for key, value in jmetrics.items():
            np.testing.assert_allclose(metrics[key], float(value), rtol=1e-4, err_msg=key)
        as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
        nets = [("generator", state_dict_from_jax, new.gen_params, 0, 1e3),
                ("discriminator", discriminator_state_dict_from_jax, new.disc_params, 1,
                 10.0)]
        for net, to_torch, params, i, max_norm in nets:
            want = to_torch(as_np(params))
            grads = None if jgrads is None else _clipped(
                {k: v.numpy() for k, v in to_torch(as_np(jgrads[i])).items()}, max_norm)
            for name, p in out["params"][net].items():
                assert _rel_l2(p.numpy(), want[name].numpy()) <= 1e-3, (net, name)
                if grads is not None:
                    assert _rel_l2(out["grads"][net][name].numpy(), grads[name]) <= 1e-3, \
                        (net, name)
    support.same_bits(ranks[0]["params"], ranks[1]["params"])


@pytest.fixture(scope="module")
def two_ranks(setup, tmp_path_factory):
    _, _, gp, dp = setup
    case = _case(gp, dp, 4, 1)
    return case, support.spawn_steps(tmp_path_factory.mktemp("ddp"), case)


def test_two_rank_step_matches_jax_mesh_step(setup, two_ranks):
    jgen, jdisc, gp, dp = setup
    case, ranks = two_ranks
    new, jmetrics, jgrads = _jax_mesh_step(jgen, jdisc, gp, dp, case["audio"], 1)
    assert set(ranks[0]["metrics"][0]) == set(jmetrics)
    _compare_with_jax(ranks, new, jmetrics, jgrads)


def test_two_rank_step_matches_one_rank_step(two_ranks):
    case, ranks = two_ranks
    alone = support.run_steps(case)
    for key, value in alone["metrics"][0].items():
        for out in ranks:
            np.testing.assert_allclose(out["metrics"][0][key], value, rtol=1e-4,
                                       err_msg=key)
    for net, params in alone["params"].items():
        for name, p in params.items():
            assert _rel_l2(ranks[0]["params"][net][name].numpy(), p.numpy()) <= 1e-3, name
            assert _rel_l2(ranks[0]["grads"][net][name].numpy(),
                           alone["grads"][net][name].numpy()) <= 1e-3, name
