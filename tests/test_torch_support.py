"""Shared set-up of the port's parity tests, and tests of the parameter
conversion itself.

Parameters come from a small JAX ``DAC_VRVQ`` (the sizes of
``test_parity_torch.py``), jittered with a seeded numpy generator so that no
bias is zero, no Snake alpha is one and no ``g`` equals ``||v||``: a layout or
grouping slip in the conversion then shows in the outputs. They reach the
port through ``vrvq_tpu_torch.convert.state_dict_from_jax``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.models import DAC_VRVQ as JaxDAC
from vrvq_tpu.native.io import wavio
import vrvq_tpu_torch as port
from vrvq_tpu_torch.convert import state_dict_from_jax
from vrvq_tpu_torch.native import io as native_io

JAX_CFG = dict(
    encoder_dim=16, encoder_rates=(2, 4, 8, 8), decoder_dim=128,
    decoder_rates=(8, 8, 4, 2), n_codebooks=4, codebook_size=64,
    codebook_dim=4, sample_rate=44100, model_type="VBR", level_min=0.125,
    level_max=6.0, imp2mask_alpha=2.0,
)
PORT_CFG = port.small_config()

# The suite runs in several worker processes on one machine: a torch process
# per worker with a thread per core made the port's tests ~10x slower than
# alone, and one thread a process gives the same results.
torch.set_num_threads(1)


def jitter(params, seed: int):
    """Seeded perturbation of a flax parameter tree (numpy leaves)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x, np.float32)
        if name == "bias":
            return x + 0.05 * rng.randn(*x.shape).astype(np.float32)
        if name == "alpha":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name == "g":
            return x * rng.uniform(0.8, 1.2, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


def own_loudness_meters() -> None:
    """Each package measures loudness with its own meter of the same kind:
    the JAX Signal with ``vrvq_tpu/native/io``'s C++ meter (built from the
    JAX package's source by ``conftest.py``), the port with its own build of
    its own copy; or, where no compiler is present, each with its numpy
    meter. A mixed pair would compare a C++ meter with a numpy one, whose
    last bits differ."""
    assert wavio.available() == (native_io.library() is not None), (
        wavio.available(), native_io.reason())


def jax_model_and_params(seed: int = 0, **overrides):
    """(JAX model, jittered numpy params) at the small test config."""
    jm = JaxDAC(**{**JAX_CFG, **overrides})
    rngs = {"params": jax.random.PRNGKey(seed),
            "vbr": jax.random.PRNGKey(seed + 1),
            "vbr_dropout": jax.random.PRNGKey(seed + 2)}
    params = jm.init(rngs, jnp.zeros((1, 1, 4096)), level=1.0)
    return jm, jitter(jax.tree_util.tree_map(np.asarray, params), seed + 10)


def port_model(params, padding: bool = True):
    """The port's small DAC_VRVQ on the CPU, loaded from JAX params."""
    model = port.build_model(PORT_CFG, device="cpu",
                             state_dict=state_dict_from_jax(params))
    return model if padding else model.clone(padding=False)


def jnp_tree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


@pytest.fixture(scope="module")
def pair():
    return jax_model_and_params(0)


def test_state_dict_covers_every_port_parameter(pair):
    """Keys and shapes of the converted tree are exactly the port's."""
    _, params = pair
    sd = state_dict_from_jax(params)
    model = port.DAC_VRVQ(PORT_CFG)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in sd.items()}
    assert got == want


@pytest.mark.parametrize("key,flax_path,transpose", [
    ("encoder.block_0.res0.conv1.v", ("encoder", "block_0", "res0", "conv1", "v"), (2, 1, 0)),
    ("decoder.block_1.up.v", ("decoder", "block_1", "up", "v"), None),
    ("quantizer.quantizers_2.in_proj.v", ("quantizer", "quantizers_2", "in_proj", "v"), None),
    ("decoder.block_1.up.g", ("decoder", "block_1", "up", "g"), None),
    ("quantizer.imp_subnet.snake_3.alpha", ("quantizer", "imp_subnet", "snake_3", "alpha"), None),
])
def test_state_dict_layouts(pair, key, flax_path, transpose):
    """Conv v (k, in, out) -> (out, in, k); ConvT and 1x1 v unchanged."""
    _, params = pair
    leaf = params["params"]
    for name in flax_path:
        leaf = leaf[name]
    expected = np.transpose(leaf, transpose) if transpose else leaf
    np.testing.assert_array_equal(state_dict_from_jax(params)[key].numpy(),
                                  expected)


def test_init_params_seeded_and_weight_norm_identity():
    """init_params is a function of the seed, and g = ||v|| makes each
    effective weight equal to v (as the JAX init does)."""
    a = port.build_model(PORT_CFG, device="cpu", seed=3)
    b = port.build_model(PORT_CFG, device="cpu", seed=3)
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    conv = a.encoder.block_1.res2.conv1
    torch.testing.assert_close(conv.weight(), conv.v, rtol=1e-6, atol=1e-7)
    up = a.decoder.block_0.up
    torch.testing.assert_close(up.weight(), up.v, rtol=1e-6, atol=1e-7)
