"""Snake's gradient in the port: the plain version of the backward kernel
against ``jax.grad`` of the JAX ``snake_reference``, ``SnakeFunction`` under
``gradcheck``, and the wrappers that have no backward (the bfloat16 modes,
K1) raising where a gradient is wanted. The polynomial float32 mode's
backward: ``tests/test_torch_snake_approx_grad.py``.

Tolerances: dx within rtol 1e-5 and dalpha within rtol 1e-4 of JAX's, each
with an atol of that tolerance times the largest element (dx = g (1 + ...)
passes through zero, and dalpha sums terms of both signs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.ops.snake import snake_reference as jax_snake
from vrvq_tpu_torch.ops import rvq_kernel
from vrvq_tpu_torch.ops import snake as tsnake
from vrvq_tpu_torch.nn.layers import Snake1d

torch.set_num_threads(1)


def _inputs(seed, shape=(3, 5, 37)):
    rng = np.random.RandomState(seed)
    x = (2.0 * rng.randn(*shape)).astype(np.float32)
    alpha = rng.uniform(0.2, 2.0, shape[1]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, alpha, g


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("shape", [(3, 5, 37), (2, 16, 264), (1, 3, 1)])
def test_backward_reference_matches_jax_grad(shape):
    x, alpha, g = _inputs(0, shape)
    dx, dalpha = tsnake.snake_backward_reference(
        torch.from_numpy(x), torch.from_numpy(alpha), torch.from_numpy(g))

    # JAX's Snake is channels-last: (B, T, C) with alpha (C,)
    def f(xj, aj):
        return jnp.sum(jax_snake(xj, aj) * jnp.asarray(g.transpose(0, 2, 1)))

    jdx, jda = jax.grad(f, argnums=(0, 1))(jnp.asarray(x.transpose(0, 2, 1)),
                                           jnp.asarray(alpha))
    _close(dx.numpy(), np.asarray(jdx).transpose(0, 2, 1), 1e-5)
    _close(dalpha.numpy(), jda, 1e-4)


def test_backward_reference_is_autograd_of_plain_forward():
    x, alpha, g = _inputs(1)
    xt = torch.from_numpy(x).requires_grad_(True)
    at = torch.from_numpy(alpha).requires_grad_(True)
    (tsnake.snake_reference(xt, at) * torch.from_numpy(g)).sum().backward()
    dx, dalpha = tsnake.snake_backward_reference(
        torch.from_numpy(x), torch.from_numpy(alpha), torch.from_numpy(g))
    _close(dx.numpy(), xt.grad.numpy(), 1e-5)
    _close(dalpha.numpy(), at.grad.numpy(), 1e-4)


def test_snake_function_gradcheck_float64():
    rng = np.random.RandomState(2)
    x = torch.tensor(rng.randn(2, 3, 7), dtype=torch.float64, requires_grad=True)
    alpha = torch.tensor(rng.uniform(0.3, 1.7, 3), dtype=torch.float64,
                         requires_grad=True)
    assert torch.autograd.gradcheck(tsnake.SnakeFunction.apply, (x, alpha))


def test_snake_routes_grad_through_snake_function():
    x, alpha, _ = _inputs(3)
    xt = torch.from_numpy(x).requires_grad_(True)
    at = torch.from_numpy(alpha).requires_grad_(True)
    y = tsnake.snake(xt, at)
    assert type(y.grad_fn).__name__ == "SnakeFunctionBackward"
    with torch.no_grad():
        assert tsnake.snake(xt, at).grad_fn is None
    torch.testing.assert_close(y.detach(), tsnake.snake_reference(
        torch.from_numpy(x), torch.from_numpy(alpha)), rtol=0, atol=0)


@pytest.mark.parametrize("approx,dtype", [(False, torch.bfloat16),
                                          (True, torch.bfloat16)],
                         ids=["exact-bf16", "poly-bf16"])
def test_modes_without_backward_raise_under_grad(approx, dtype):
    x, alpha, _ = _inputs(4)
    xt = torch.from_numpy(x).to(dtype)
    at = torch.from_numpy(alpha).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        tsnake.snake(xt, at, approx=approx)
    layer = Snake1d(x.shape[1], approx=approx)
    with pytest.raises(RuntimeError, match="no backward"):
        layer(xt)
    with torch.no_grad():  # serving: no gradient wanted, the plain version
        torch.testing.assert_close(
            tsnake.snake(xt, at, approx=approx),
            tsnake.snake_plain(xt, at.detach(), approx), rtol=0, atol=0)


def test_fused_rvq_raises_under_grad():
    rng = np.random.RandomState(5)
    nq, d_model, d, k = 2, 16, 4, 8
    w = [torch.from_numpy(rng.randn(*s).astype(np.float32))
         for s in ((nq, d_model, d), (nq, d), (nq, d, d_model), (nq, d_model),
                   (nq, k, d))]
    z = torch.from_numpy(rng.randn(6, d_model).astype(np.float32))
    w[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        rvq_kernel.fused_rvq(z, *w)
    with pytest.raises(RuntimeError, match="no backward"):
        rvq_kernel.fused_rvq_prepared(z, rvq_kernel.prepare_rvq(
            rvq_kernel.RVQWeights(*w)))
    with torch.no_grad():
        zq, codes = rvq_kernel.fused_rvq(z, *w)
    assert zq.shape == z.shape and codes.shape == (6, nq)
