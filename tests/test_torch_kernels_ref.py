"""Plain versions of the port's two kernels against the JAX package's.

K1 (fused RVQ): ``fused_rvq_reference`` against the JAX ``fused_rvq`` run in
interpret mode, against the JAX plain reference and against the port's module
quantizer: codes bit-identical, z_q within 1e-5, in VBR (random 0/1 mask)
and CBR, with F not a multiple of any tile. K2 (Snake): ``snake_reference``
against the JAX ``snake_reference`` and ``snake_pallas(interpret=True)``
within 1e-6. Plus the wrappers' guards: on a tensor that is neither on the
CPU nor on the card they raise, and never fall back.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.models.quantize import VBRResidualVectorQuantize as JaxVBR
from vrvq_tpu.ops import rvq_kernel as jrvq
from vrvq_tpu.ops.snake import snake_pallas, snake_reference
from vrvq_tpu_torch.convert import state_dict_from_jax
from vrvq_tpu_torch.models.quantize import VBRResidualVectorQuantize
from vrvq_tpu_torch.ops import rvq_kernel as trvq
from vrvq_tpu_torch.ops import snake as tsnake
from tests.test_torch_support import jitter

ZQ_TOL = 1e-5
SNAKE_TOL = 1e-6


@pytest.fixture(scope="module", params=[(128, 4, 128, 8), (256, 4, 64, 4)],
                ids=["D128-d8", "D256-d4"])
def quantizers(request):
    """(JAX params subtree, port quantizer) sharing jittered weights."""
    dim, nq, k, d = request.param
    jm = JaxVBR(input_dim=dim, n_codebooks=nq, codebook_size=k,
                codebook_dim=d, level_min=0.125, level_max=6.0)
    z = jnp.zeros((1, 8, dim))
    params = jm.init({"params": jax.random.PRNGKey(0),
                      "vbr": jax.random.PRNGKey(1),
                      "vbr_dropout": jax.random.PRNGKey(2)},
                     z, feat_enc=z, level=1.0)
    params = jitter(jax.tree_util.tree_map(np.asarray, params), 5)
    tq = VBRResidualVectorQuantize(dim, nq, k, d)
    tq.load_state_dict(state_dict_from_jax(params), strict=True)
    return params["params"], tq.eval(), dim, nq


def test_stacked_weights_match_jax(quantizers):
    jparams, tq, _, nq = quantizers
    jw = jrvq.stack_quantizer_weights(jparams, nq)
    with torch.inference_mode():
        tw = trvq.stack_quantizer_weights(tq)
    for name, a, b in zip(trvq.RVQWeights._fields, tw, jw):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


@pytest.mark.parametrize("vbr", [True, False], ids=["VBR", "CBR"])
def test_fused_reference_matches_jax_kernel(quantizers, vbr):
    jparams, tq, dim, nq = quantizers
    rng = np.random.RandomState(1)
    z = rng.randn(300, dim).astype(np.float32)  # 300: no multiple of a tile
    mask = (rng.rand(300, nq) > 0.4).astype(np.float32) if vbr else None

    jw = jrvq.stack_quantizer_weights(jparams, nq)
    jmask = jnp.asarray(mask) if vbr else None
    k_zq, k_codes = jrvq.fused_rvq(jnp.asarray(z), *jw, jmask, interpret=True)
    r_zq, r_codes = jrvq.fused_rvq_reference(jnp.asarray(z), *jw, jmask)

    with torch.inference_mode():
        tw = trvq.stack_quantizer_weights(tq)
        zq, codes = trvq.fused_rvq_reference(
            torch.from_numpy(z), *tw,
            torch.from_numpy(mask) if vbr else None)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(k_codes))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(r_codes))
    np.testing.assert_allclose(zq.numpy(), np.asarray(k_zq), rtol=ZQ_TOL,
                               atol=ZQ_TOL)
    np.testing.assert_allclose(zq.numpy(), np.asarray(r_zq), rtol=ZQ_TOL,
                               atol=ZQ_TOL)


def test_fused_wrapper_on_cpu_matches_module_quantizer(quantizers):
    """quantize_fused (which takes the plain version for CPU tensors) gives
    the module quantizer's codes and unmasked z_q."""
    _, tq, dim, nq = quantizers
    rng = np.random.RandomState(2)
    z = torch.from_numpy(rng.randn(2, dim, 37).astype(np.float32))
    with torch.inference_mode():
        out = tq(z, feat_enc=z, level=100.0)  # level high: every stage kept
        zq, codes = trvq.quantize_fused(
            trvq.prepare_rvq(trvq.stack_quantizer_weights(tq)), z)
    np.testing.assert_array_equal(codes.numpy(), out["codes"].numpy())
    torch.testing.assert_close(zq, out["z_q_is"].sum(1), rtol=ZQ_TOL,
                               atol=ZQ_TOL)


@pytest.mark.parametrize("shape", [(2, 16, 1024), (1, 96, 700)])
def test_snake_reference_matches_jax(shape):
    rng = np.random.RandomState(shape[1])
    x = (3.0 * rng.randn(*shape)).astype(np.float32)  # (B, C, T)
    alpha = rng.uniform(0.1, 2.0, shape[1]).astype(np.float32)
    x_btc = jnp.asarray(x.transpose(0, 2, 1))
    ref = np.asarray(snake_reference(x_btc, jnp.asarray(alpha)))
    pallas = np.asarray(snake_pallas(x_btc, jnp.asarray(alpha),
                                     block_t=512, interpret=True))
    got = tsnake.snake(torch.from_numpy(x), torch.from_numpy(alpha)).numpy()
    got_btc = got.transpose(0, 2, 1)
    np.testing.assert_allclose(got_btc, ref, rtol=SNAKE_TOL, atol=SNAKE_TOL)
    np.testing.assert_allclose(got_btc, pallas, rtol=SNAKE_TOL, atol=SNAKE_TOL)


def test_wrappers_never_fall_back():
    """A tensor off the CPU goes to the kernel or raises: on a device with
    no kernel (here 'meta') both wrappers raise instead of computing the
    plain version."""
    x = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tsnake.snake(x, torch.empty(4, device="meta"))
    w = [torch.empty(s, device="meta") for s in
         [(2, 8, 4), (2, 4), (2, 4, 8), (2, 8), (2, 16, 4)]]
    with pytest.raises(ValueError, match="unsupported device"):
        trvq.fused_rvq(torch.empty(5, 8, device="meta"), *w)


def test_cuda_request_without_cuda_raises():
    """Entry points default to the card; on a machine without CUDA asking
    for it raises instead of running on the CPU."""
    import vrvq_tpu_torch as port

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.build_model(port.small_config())


@pytest.mark.parametrize("d", [1, 2, 3, 4, 8, 16, 32])
@pytest.mark.parametrize("dim,k", [(1000, 6), (6, 1000), (6, 6)],
                         ids=["D1000-K6", "D6-K1000", "D6-K6"])
def test_fused_reference_matches_jax_kernel_at_every_codebook_shape(dim, k, d):
    """K1's plain version against the JAX kernel (interpret mode) at the
    codebook shapes the port's kernel pads, VBR: codes identical off near
    ties (top-2 margin <= 1e-5: at d = 2 a thousand codes crowd the unit
    circle, and XLA and PyTorch sum e in another order), z_q within 1e-5 on
    the frames that agree."""
    rng = np.random.RandomState(dim + k + d)
    nq, frames = 2, 17
    w = [(rng.uniform(-1, 1, (nq, dim, d)) / np.sqrt(dim)).astype(np.float32),
         (0.1 * rng.randn(nq, d)).astype(np.float32),
         (rng.uniform(-1, 1, (nq, d, dim)) / np.sqrt(d)).astype(np.float32),
         (0.1 * rng.randn(nq, dim)).astype(np.float32),
         rng.randn(nq, k, d).astype(np.float32)]
    z = rng.randn(frames, dim).astype(np.float32)
    mask = (rng.rand(frames, nq) > 0.4).astype(np.float32)
    k_zq, k_codes = jrvq.fused_rvq(jnp.asarray(z), *map(jnp.asarray, w),
                                   jnp.asarray(mask), interpret=True)
    zq, codes = trvq.fused_rvq(torch.from_numpy(z), *map(torch.from_numpy, w),
                               torch.from_numpy(mask))
    near_tie = (trvq.reference_margins(torch.from_numpy(z),
                                       *map(torch.from_numpy, w)) <= 1e-5).numpy()
    agree = (codes.numpy() == np.asarray(k_codes)).all(axis=1)
    assert not (~agree & ~near_tie).any()
    assert agree.mean() > 0.9
    np.testing.assert_allclose(zq.numpy()[agree], np.asarray(k_zq)[agree],
                               rtol=ZQ_TOL, atol=ZQ_TOL)
