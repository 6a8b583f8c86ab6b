"""The polynomial Snake's gradient in the port: the plain version of its
backward kernel (``snake_approx_backward_reference``) against ``jax.grad``
of the JAX ``snake_approx``, over |alpha x| up to 40 and at the multiples of
pi/2 where the reduction's k jumps; ``SnakeFunction(approx=True)`` and a
polynomial ``Snake1d`` under grad on the CPU give the same. Bar: dx and
dalpha within 1e-5 relative L2 of JAX's (float32 roundings in another order;
the polynomial itself is the same)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from vrvq_tpu.ops.snake import snake_approx as jax_snake_approx
from vrvq_tpu_torch.nn.layers import Snake1d
from vrvq_tpu_torch.ops import snake as tsnake

torch.set_num_threads(1)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _inputs(seed, shape, kind):
    rng = np.random.RandomState(seed)
    alpha = rng.uniform(0.3, 3.0, shape[1]).astype(np.float32)
    if kind == "wide":  # |alpha x| up to 40
        u = rng.uniform(-40.0, 40.0, shape)
    else:  # within a few ulps of k pi/2, where k's rounding jumps
        k = rng.randint(-25, 26, shape)
        u = k * (np.pi / 2) * (1.0 + rng.choice([-1, 0, 1], shape) * 1e-7)
    x = (u / alpha[None, :, None]).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, alpha, g


def _jax_grads(x, alpha, g):
    """jax.grad of sum(snake_approx * g) in the JAX layout (B, T, C)."""
    xj = jnp.asarray(x.transpose(0, 2, 1))
    gj = jnp.asarray(g.transpose(0, 2, 1))
    dx, da = jax.grad(lambda xx, aa: jnp.sum(jax_snake_approx(xx, aa) * gj),
                      argnums=(0, 1))(xj, jnp.asarray(alpha))
    return np.asarray(dx).transpose(0, 2, 1), np.asarray(da)


@pytest.mark.parametrize("kind", ["wide", "k-jumps"])
@pytest.mark.parametrize("shape", [(2, 5, 997), (1, 3, 1), (4, 16, 264)])
def test_backward_reference_matches_jax_grad(shape, kind):
    x, alpha, g = _inputs(sum(shape), shape, kind)
    dx, da = tsnake.snake_approx_backward_reference(
        torch.from_numpy(x), torch.from_numpy(alpha), torch.from_numpy(g))
    want_dx, want_da = _jax_grads(x, alpha, g)
    assert _rel_l2(dx.numpy(), want_dx) <= 1e-5
    assert _rel_l2(da.numpy(), want_da) <= 1e-5


def test_snake_function_and_layer_take_the_polynomial_backward():
    x, alpha, g = _inputs(7, (2, 6, 300), "wide")
    xt = torch.from_numpy(x).requires_grad_(True)
    at = torch.from_numpy(alpha).requires_grad_(True)
    y = tsnake.snake(xt, at, approx=True)
    assert type(y.grad_fn).__name__ == "SnakeFunctionBackward"
    torch.testing.assert_close(y.detach(), tsnake.snake_approx_reference(
        torch.from_numpy(x), torch.from_numpy(alpha)), rtol=0, atol=0)
    y.backward(torch.from_numpy(g))
    dx, da = tsnake.snake_approx_backward_reference(
        torch.from_numpy(x), torch.from_numpy(alpha), torch.from_numpy(g))
    torch.testing.assert_close(xt.grad, dx, rtol=0, atol=0)
    torch.testing.assert_close(at.grad, da, rtol=0, atol=0)
    want_dx, want_da = _jax_grads(x, alpha, g)
    assert _rel_l2(xt.grad.numpy(), want_dx) <= 1e-5
    assert _rel_l2(at.grad.numpy(), want_da) <= 1e-5

    layer = Snake1d(6, approx=True)
    with torch.no_grad():
        layer.alpha.copy_(torch.from_numpy(alpha))
    xl = torch.from_numpy(x).requires_grad_(True)
    layer(xl).backward(torch.from_numpy(g))
    torch.testing.assert_close(xl.grad, dx, rtol=0, atol=0)
    torch.testing.assert_close(layer.alpha.grad, da, rtol=0, atol=0)


def test_backward_reference_is_autograd_of_the_plain_forward():
    """The formula is the derivative of the plain forward: autograd through
    ``sin2_approx`` in float64 agrees to 1e-6 of the largest element (P'
    takes the float32 values of i C_i, the forward the decimal C_i)."""
    x, alpha, g = _inputs(3, (2, 4, 200), "wide")
    xd = torch.from_numpy(x).double().requires_grad_(True)
    ad = torch.from_numpy(alpha).double().requires_grad_(True)
    u = ad.reshape(1, -1, 1) * xd
    (xd + tsnake.sin2_approx(u) * (1.0 / (ad.reshape(1, -1, 1) + 1e-9))).backward(
        torch.from_numpy(g).double())
    dx, da = tsnake.snake_approx_backward_reference(
        torch.from_numpy(x).double(), torch.from_numpy(alpha).double(),
        torch.from_numpy(g).double())
    for got, want in ((dx, xd.grad), (da, ad.grad)):
        torch.testing.assert_close(got, want, rtol=1e-6,
                                   atol=1e-6 * float(want.abs().max()))
