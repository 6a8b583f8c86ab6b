"""The port's discriminator against the JAX package's, from the same
parameters.

A small ensemble (MPD at periods 2 and 3, MRD at one FFT size of 512 with the
five bands of ``conf/base.yml``) initialized by JAX, jittered so that no bias
is zero and no ``g`` equals ``||v||``, and converted with
``discriminator_state_dict_from_jax``. Every feature map agrees within rtol
1e-5 (atol 1e-5 of the map's scale; the port's maps are ``(B, C, H, W)``, the
JAX package's ``(B, H, W, C)``), and the LSGAN discriminator loss's gradient
agrees leaf by leaf within 1e-3 relative L2 of ``jax.grad``'s.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.losses.gan import discriminator_loss as j_disc_loss
from vrvq_tpu.models import Discriminator as JaxDisc
from vrvq_tpu_torch.convert import discriminator_state_dict_from_jax, init_params
from vrvq_tpu_torch.losses.gan import discriminator_loss
from vrvq_tpu_torch.models.discriminator import Discriminator
from tests.test_torch_support import jitter

torch.set_num_threads(1)

PERIODS, FFTS = (2, 3), (512,)


@pytest.fixture(scope="module")
def discs():
    jd = JaxDisc(periods=PERIODS, fft_sizes=FFTS)
    params = jd.init(jax.random.PRNGKey(3), jnp.zeros((1, 1, 4096)))
    params = jitter(jax.tree_util.tree_map(np.asarray, params), 4)
    td = Discriminator(periods=PERIODS, fft_sizes=FFTS)
    td.load_state_dict(discriminator_state_dict_from_jax(params), strict=True)
    return jd, jax.tree_util.tree_map(jnp.asarray, params), td


def _audio(seed, n=2, t=4000):
    rng = np.random.RandomState(seed)
    return (0.2 * rng.randn(n, 1, t)).astype(np.float32)


def test_state_dict_covers_every_parameter(discs):
    _, params, td = discs
    sd = discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params))
    assert set(sd) == set(td.state_dict())
    for k, v in td.state_dict().items():
        assert tuple(sd[k].shape) == tuple(v.shape), k


@pytest.mark.parametrize("length", [4000, 4001])
def test_feature_maps_match_jax(discs, length):
    jd, params, td = discs
    x = _audio(0, t=length)
    with torch.no_grad():
        got = td(torch.from_numpy(x))
    want = jd.apply(params, jnp.asarray(x))
    assert len(got) == len(want) == len(PERIODS) + len(FFTS)
    for gd, wd in zip(got, want):
        assert len(gd) == len(wd)
        for g, w in zip(gd, wd):
            w = np.asarray(w).transpose(0, 3, 1, 2)
            assert tuple(g.shape) == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(w).max()))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_lsgan_disc_loss_grads_match_jax(discs):
    jd, params, td = discs
    fake, real = _audio(1), _audio(2)
    td.zero_grad()
    loss = discriminator_loss(td(torch.from_numpy(fake)), td(torch.from_numpy(real)))
    loss.backward()

    def jloss(p):
        return j_disc_loss(jd.apply(p, jnp.asarray(fake)), jd.apply(p, jnp.asarray(real)))

    want, jgrads = jax.value_and_grad(jloss)(params)
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    jsd = discriminator_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in td.named_parameters():
        assert p.grad is not None and torch.count_nonzero(p.grad) > 0, name
        assert _rel_l2(p.grad.numpy(), jsd[name].numpy()) <= 1e-3, name


def test_init_matches_jax_scheme():
    """``init_params`` draws a 2-D conv's ``v`` in +-1/sqrt(fan_in) with
    ``g = ||v||`` and zero bias, as the JAX ``WNConv2d`` does."""
    td = Discriminator(periods=(2,), fft_sizes=(512,))
    init_params(td, torch.Generator().manual_seed(0))
    conv = td.mpd_2.conv_1
    fan_in = 32 * 5 * 1
    assert conv.v.abs().max() <= 1 / np.sqrt(fan_in)
    torch.testing.assert_close(conv.weight(), conv.v)
    assert torch.all(conv.bias == 0)
