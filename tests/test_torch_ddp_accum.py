"""The port's data-parallel accumulated step (``grad_accum_steps`` K = 2) on
the CPU: two gloo ranks, each a process of its own, against the JAX
package's ``make_accum_train_step`` jitted over a 2-device ``data`` mesh.

The small configuration, draws and bars of ``tests/test_torch_ddp.py`` on a
global batch of 8 as 2 micro-batches of 4; the JAX scan gives every
micro-batch the same pinned draws, and so does the port.
"""

import torch

from tests import test_torch_dist_support as support
from tests.test_torch_ddp import _case, _compare_with_jax, _jax_mesh_step, setup

torch.set_num_threads(1)


def test_two_rank_accumulated_step_matches_jax_mesh_step(setup, tmp_path):
    """K = 2 over a global batch of 8: rank r holds rows 2r, 2r + 1 of each
    micro-batch of 4 (``local_rows``), not a block of the batch."""
    jgen, jdisc, gp, dp = setup
    case = _case(gp, dp, 8, 2)
    ranks = support.spawn_steps(tmp_path, case, accum=2)
    new, jmetrics, _ = _jax_mesh_step(jgen, jdisc, gp, dp, case["audio"], 2)
    _compare_with_jax(ranks, new, jmetrics, None)
