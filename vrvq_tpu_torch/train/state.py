"""The training state and the optimizers.

Counterpart of ``vrvq_tpu/train/state.py``. ``make_optimizer`` is the JAX
package's optax chain: clipping by global norm, then AdamW (β 0.8 / 0.99,
ε 1e-8, weight decay 1e-2) at the learning rate of the schedule evaluated at
the update count before the update (optax's ``count``). The clip is optax's
expression, ``(g / norm) * max_norm`` where ``norm >= max_norm`` (not
``clip_grad_norm_``, which adds 1e-6 to the norm). Reading the norm on the
host waits for the gradients: that wait is the span ``clip_sync``.

``zero=True`` shards AdamW's state over the ranks of the process group
(``parallel.zero_optimizer``, the JAX package's ``zero_shard_opt_state``):
the clip and the schedule run on the full gradients, which the train step
has averaged over the ranks, and each rank updates the parameters it owns.
Its ``state_dict`` is collective: every rank calls it, rank 0 gets the
replicated optimizer's layout (other ranks None), so a checkpoint does not
depend on the number of ranks. As in JAX, ZeRO is an argument, not a config
key.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

import torch
from torch import nn

from ..parallel import dist as pdist
from ..utils import annotate
from .schedule import exponential_lr


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """``sqrt(sum of squares)`` over every tensor, a 0-d tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))


class Optimizer:
    """Global-norm clip + AdamW + per-step exponential learning rate over
    ``params``, reading and updating their ``.grad``."""

    def __init__(self, params: Iterable[nn.Parameter], lr: float = 1e-4,
                 betas=(0.8, 0.99), weight_decay: float = 1e-2,
                 gamma: float = 0.999996, warmup: int = 0,
                 max_grad_norm: Optional[float] = None, zero: bool = False):
        self.params = list(params)
        self.schedule = exponential_lr(lr, gamma, warmup)
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.zero = zero
        make = pdist.zero_optimizer if zero else torch.optim.AdamW
        self.adamw = make(self.params, lr=self.schedule(0), betas=tuple(betas),
                          eps=1e-8, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """Clip the gradients in place, update, advance the schedule; returns
        the gradients' global norm before the clip."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        for p, g in zip(self.params, grads):
            p.grad = g
        norm = global_norm(grads)
        if self.max_grad_norm is not None:
            with annotate("clip_sync"):
                clip = float(norm) >= self.max_grad_norm
            if clip:
                torch._foreach_div_(grads, norm)
                torch._foreach_mul_(grads, self.max_grad_norm)
        for group in self.adamw.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adamw.step()
        self.count += 1
        return norm

    def state_dict(self) -> Optional[dict]:
        """The AdamW state and the update count. Under ZeRO a collective:
        rank 0 gets the whole state, the other ranks None."""
        if not self.zero:
            return {"adamw": self.adamw.state_dict(), "count": self.count}
        self.adamw.consolidate_state_dict(to=0)
        if pdist.rank() != 0:
            return None
        return {"adamw": self.adamw.state_dict(), "count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        self.adamw.load_state_dict(sd["adamw"])
        self.count = int(sd["count"])


def make_optimizer(params: Iterable[nn.Parameter], **kwargs) -> Optimizer:
    """The trainer's optimizer, ``Optimizer``'s arguments (the trainer clips
    at 1e3 for the generator, 10 for the discriminator)."""
    return Optimizer(params, **kwargs)


@dataclasses.dataclass
class TrainState:
    """Both networks, both optimizers and the number of steps taken."""

    generator: nn.Module
    discriminator: nn.Module
    opt_g: Optimizer
    opt_d: Optimizer
    step: int = 0
