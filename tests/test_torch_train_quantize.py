"""The port's VBR quantizer in train mode against the JAX package's.

A small quantizer (D 128, 4 codebooks of 64 x 4) with ``quantizer_dropout
0.25`` and ``full_codebook_rate 0.25`` over a batch of 4, so all three rows
of the partition run: 2 importance-masked, 1 random-depth, 1 full. The random
draws are pinned on both sides: the JAX samplers are monkeypatched inside the
test (the level draw and the depth draw are the only ones of their shapes),
the port is handed the same ``levels`` and ``depths``. Masks and codes are
equal, z_q, the losses and ``imp_map`` agree within rtol 1e-5.

And the two straight-through estimators, whose detaches the serving code
left out: z_e receives the gradient of z_q (the encoder learns through the
quantizer), and the mask's gradient is the smooth mask's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.models.quantize import VBRResidualVectorQuantize as JaxVBR
from vrvq_tpu.models.quantize import VectorQuantize as JaxVQ
from vrvq_tpu.ops import masks as jmasks
from vrvq_tpu_torch.convert import state_dict_from_jax
from vrvq_tpu_torch.models.quantize import VBRResidualVectorQuantize, VectorQuantize
from vrvq_tpu_torch.ops import masks as tmasks
from tests.test_torch_support import jitter

torch.set_num_threads(1)

DIM, NQ, K, D = 128, 4, 64, 4
BS, T = 4, 9
KW = dict(quantizer_dropout=0.25, full_codebook_rate=0.25, level_min=0.125,
          level_max=6.0, imp2mask_alpha=2.0)
U = np.array([0.13, 0.55, 0.92, 0.31], np.float32)
DEPTHS = np.array([1], np.int64)


@pytest.fixture(scope="module")
def quantizers():
    jm = JaxVBR(input_dim=DIM, n_codebooks=NQ, codebook_size=K, codebook_dim=D,
                **KW)
    z = jnp.zeros((1, 8, DIM))
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "vbr": jax.random.PRNGKey(1),
                      "vbr_dropout": jax.random.PRNGKey(2)},
                     z, feat_enc=z, level=1.0)
    params = jitter(jax.tree_util.tree_map(np.asarray, params), 6)
    tq = VBRResidualVectorQuantize(DIM, NQ, K, D, **KW)
    tq.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, jax.tree_util.tree_map(jnp.asarray, params), tq


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    z = (rng.randn(BS, DIM, T)).astype(np.float32)
    feat = (rng.randn(BS, DIM, T)).astype(np.float32)
    return z, feat


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


def _jax_train(jm, params, z, feat):
    return jm.apply(params, jnp.asarray(z.transpose(0, 2, 1)),
                    feat_enc=jnp.asarray(feat.transpose(0, 2, 1)), train=True,
                    rngs={"vbr": jax.random.PRNGKey(7),
                          "vbr_dropout": jax.random.PRNGKey(8)})


def _port_levels(tq):
    return tq.random_levels(torch.from_numpy(U))


def test_partition_truncates_as_jax(quantizers):
    _, _, tq = quantizers
    assert tq.partition(4) == (2, 1, 1)
    assert tq.partition(16) == (8, 4, 4)
    assert tq.partition(6) == (4, 1, 1)  # int(1.5) == 1 for both


def test_train_forward_matches_jax(quantizers, monkeypatch):
    jm, params, tq = quantizers
    z, feat = _inputs()
    pinned_jax(monkeypatch)
    jout = _jax_train(jm, params, z, feat)
    with torch.no_grad():
        tout = tq(torch.from_numpy(z), feat_enc=torch.from_numpy(feat), train=True,
                  levels=_port_levels(tq), depths=DEPTHS)
    np.testing.assert_array_equal(tout["mask_imp"].numpy(), np.asarray(jout["mask_imp"]))
    np.testing.assert_array_equal(tout["codes"].numpy(), np.asarray(jout["codes"]))
    # the dropout row keeps stage i iff depth - i >= 0, the full row all
    mask = tout["mask_imp"].numpy()
    keep = DEPTHS[0] + 1
    assert (mask[2, :keep] == 1).all() and (mask[2, keep:] == 0).all()
    assert (mask[3] == 1).all()
    np.testing.assert_allclose(tout["z_q"].numpy(),
                               np.asarray(jout["z_q"]).transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-6)
    for key in ("commitment_loss", "codebook_loss"):
        np.testing.assert_allclose(tout[key].item(), float(jout[key]), rtol=1e-5)
    assert tout["imp_map"].shape == (2, 1, T)  # the importance rows only
    np.testing.assert_allclose(tout["imp_map"].numpy(), np.asarray(jout["imp_map"]),
                               rtol=1e-5, atol=1e-7)


def test_train_draws_come_from_the_generator(quantizers):
    _, _, tq = quantizers
    z, feat = _inputs(1)
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(11)
        with torch.no_grad():
            outs.append(tq(torch.from_numpy(z), feat_enc=torch.from_numpy(feat),
                           train=True, generator=gen))
    torch.testing.assert_close(outs[0]["mask_imp"], outs[1]["mask_imp"], rtol=0, atol=0)
    gen = torch.Generator().manual_seed(11)
    levels = tq.random_levels(torch.rand((BS, 1, 1), generator=gen))
    assert ((levels >= 0.125) & (levels <= 6.0)).all()


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_z_e_receives_the_gradient_of_z_q(quantizers, monkeypatch):
    """The straight-through estimator passes d z_q to z (through in_proj),
    as JAX's ``z_e + stop_gradient(z_q - z_e)`` does."""
    jm, params, tq = quantizers
    z, feat = _inputs(2)
    r = np.random.RandomState(3).randn(BS, DIM, T).astype(np.float32)
    pinned_jax(monkeypatch)

    def jloss(zj):
        out = jm.apply(params, zj, feat_enc=jnp.asarray(feat.transpose(0, 2, 1)),
                       train=True, rngs={"vbr": jax.random.PRNGKey(7),
                                         "vbr_dropout": jax.random.PRNGKey(8)})
        return jnp.sum(out["z_q"] * jnp.asarray(r.transpose(0, 2, 1)))

    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(z.transpose(0, 2, 1))))
    zt = torch.from_numpy(z).requires_grad_(True)
    out = tq(zt, feat_enc=torch.from_numpy(feat), train=True,
             levels=_port_levels(tq), depths=DEPTHS)
    (out["z_q"] * torch.from_numpy(r)).sum().backward()
    assert zt.grad is not None and zt.grad.abs().max() > 0
    assert _rel_l2(zt.grad.numpy(), jgrad.transpose(0, 2, 1)) <= 1e-5
    assert tq.quantizers[0].in_proj.v.grad.abs().max() > 0


def test_stage_straight_through_gradient_matches_jax():
    """One stage: d z_q / d z through the straight-through estimator, and
    the in_proj weight's gradient, equal JAX's."""
    jvq = JaxVQ(DIM, K, D)
    params = jvq.init(jax.random.PRNGKey(5), jnp.zeros((1, 3, DIM)))
    params = jitter(jax.tree_util.tree_map(np.asarray, params), 9)
    tvq = VectorQuantize(DIM, K, D)
    tvq.load_state_dict(state_dict_from_jax(params), strict=True)
    z, _ = _inputs(5)
    r = np.random.RandomState(6).randn(BS, DIM, T).astype(np.float32)
    jgrad = jax.grad(lambda zj: jnp.sum(
        jvq.apply(jax.tree_util.tree_map(jnp.asarray, params), zj)[0]
        * jnp.asarray(r.transpose(0, 2, 1))))(jnp.asarray(z.transpose(0, 2, 1)))
    zt = torch.from_numpy(z).requires_grad_(True)
    (tvq(zt)[0] * torch.from_numpy(r)).sum().backward()
    assert zt.grad is not None
    assert _rel_l2(zt.grad.numpy(), np.asarray(jgrad).transpose(0, 2, 1)) <= 1e-5
    assert tvq.in_proj.v.grad is not None and tvq.in_proj.v.grad.abs().max() > 0


def test_mask_gradient_is_the_smooth_masks():
    rng = np.random.RandomState(4)
    x = (rng.rand(3, 1, 11) * 6).astype(np.float32)
    r = rng.randn(3, NQ, 11).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    mask = tmasks.generate_mask_ste(xt, NQ, alpha=2.0)
    np.testing.assert_array_equal(
        mask.detach().numpy(), tmasks.generate_mask_hard(torch.from_numpy(x), NQ).numpy())
    (mask * torch.from_numpy(r)).sum().backward()
    xs = torch.from_numpy(x).requires_grad_(True)
    smooth = tmasks.logcosh(2.0, xs - torch.arange(NQ, dtype=torch.float32).reshape(1, NQ, 1))
    (smooth * torch.from_numpy(r)).sum().backward()
    assert xt.grad.abs().max() > 0
    torch.testing.assert_close(xt.grad, xs.grad, rtol=0, atol=0)
    jgrad = jax.grad(lambda a: jnp.sum(jmasks.generate_mask_ste(a, NQ, 2.0)
                                       * jnp.asarray(r)))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-5, atol=1e-7)
