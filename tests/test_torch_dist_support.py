"""What the port's data-parallel tests share: a small configuration, and the
functions that each rank runs in a process of its own
(``vrvq_tpu_torch.parallel.spawn``, gloo on the CPU). This module imports
torch and the port only, so a rank starts without JAX; it holds no tests.

A case is a file ``case.pt`` in a directory: the generator's and the
discriminator's state dicts, the global batch ``audio (B, 1, T)`` and the
pinned draws of the global batch (``levels``, ``depths``; lists of each
micro-batch's with micro-batches). Each rank writes ``rank{r}.pt``.
"""

from pathlib import Path

import numpy as np
import torch

import vrvq_tpu_torch as port
from vrvq_tpu_torch.convert import init_params
from vrvq_tpu_torch.losses import L1Loss, MelSpectrogramLoss, MultiScaleSTFTLoss
from vrvq_tpu_torch.models.discriminator import Discriminator
from vrvq_tpu_torch.parallel import dist as pdist
from vrvq_tpu_torch.train import loop, trainer
from vrvq_tpu_torch.train.state import TrainState, make_optimizer

# two encoder and two decoder blocks: the flagship's topology, small enough
# that JAX compiles its steps in seconds
MINI = dict(encoder_dim=8, encoder_rates=(2, 4), decoder_dim=32,
            decoder_rates=(4, 2), n_codebooks=4, codebook_size=32,
            codebook_dim=4, level_min=0.125, level_max=6.0,
            imp2mask_alpha=2.0, quantizer_dropout=0.25,
            full_codebook_rate=0.25)
PERIODS, FFTS = (2,), (256,)
LAMBDAS = {"mel/loss": 15.0, "adv/feat_loss": 2.0, "adv/gen_loss": 1.0,
           "vq/commitment_loss": 0.25, "vq/codebook_loss": 1.0,
           "vq/rate_loss": 2.0, "stft/loss": 1.0, "waveform/loss": 10.0}
LOSS_KW = dict(stft=dict(window_lengths=(256, 64)),
               mel=dict(n_mels=(20, 10), window_lengths=(256, 64),
                        mel_fmin=(0, 0), mel_fmax=(None, None), pow=1.0,
                        mag_weight=0.0))
SECONDS = 0.06  # a clip: 2646 samples
TIMEOUT_S = 240  # each group of spawned ranks


def audio(batch: int) -> np.ndarray:
    """``batch`` seeded clips (B, 1, T)."""
    return np.concatenate([port.synthetic_clip(SECONDS, 44100, 17 + 6 * i)
                           for i in range(batch)])


def seeded_case(batch: int, seed: int = 0) -> dict:
    """A case of seeded parameters (``init_params``), ``batch`` clips and the
    draws of that batch from a seeded generator."""
    draw = torch.Generator().manual_seed(seed)
    gen = init_params(port.DAC_VRVQ(port.small_config(**MINI)), draw)
    disc = init_params(Discriminator(periods=PERIODS, fft_sizes=FFTS), draw)
    return {"gen": gen.state_dict(), "disc": disc.state_dict(), "audio": audio(batch),
            **gen.draws(batch, torch.Generator().manual_seed(seed + 1),
                        torch.device("cpu"))}


def spawn_steps(root: Path, case: dict, ranks: int = 2, accum: int = 1,
                zero: bool = False, steps: int = 1) -> list:
    """``step_rank`` in ``ranks`` gloo processes on ``case``; their results."""
    torch.save(case, root / "case.pt")
    pdist.spawn(step_rank, ranks, str(root), accum, zero, steps, backend="gloo",
                timeout=TIMEOUT_S)
    return [torch.load(root / f"rank{r}.pt", weights_only=False) for r in range(ranks)]


def same_bits(a, b, where=""):
    """Nested dicts, lists, tensors and numbers equal bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            same_bits(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            same_bits(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert torch.equal(a, b), where
    else:
        assert a == b, (where, a, b)


def losses():
    return (MultiScaleSTFTLoss(**LOSS_KW["stft"]),
            MelSpectrogramLoss(**LOSS_KW["mel"]), L1Loss())


def train_state(gen_sd, disc_sd, zero: bool = False, device="cpu") -> TrainState:
    gen = port.DAC_VRVQ(port.small_config(**MINI))
    gen.load_state_dict(gen_sd, strict=True)
    disc = Discriminator(periods=PERIODS, fft_sizes=FFTS)
    disc.load_state_dict(disc_sd, strict=True)
    gen, disc = gen.to(device), disc.to(device)
    return TrainState(gen, disc,
                      make_optimizer(gen.parameters(), max_grad_norm=1e3, zero=zero),
                      make_optimizer(disc.parameters(), max_grad_norm=10.0, zero=zero))


def run_steps(case: dict, accum: int = 1, zero: bool = False, steps: int = 1,
              remat: bool = False, device="cpu") -> dict:
    """``steps`` steps of this rank (of the current process group, or alone)
    on its rows of the case's batch, on ``device``; the results, with each
    parameter's gradient of the last update (averaged and clipped) and both
    optimizers' state dicts (rank 0's under ZeRO)."""
    torch.set_num_threads(1)
    state = train_state(case["gen"], case["disc"], zero, device)
    step = loop.make_train_step(LAMBDAS, *losses(), accum_steps=accum, remat=remat)
    rows = pdist.local_rows(len(case["audio"]), pdist.rank(), pdist.world(), accum)
    x = torch.from_numpy(np.ascontiguousarray(case["audio"][rows])).to(device)
    metrics = [step(state, x, levels=case["levels"], depths=case["depths"])
               for _ in range(steps)]
    nets = {"generator": state.generator, "discriminator": state.discriminator}
    return {
        "metrics": [{k: v.item() for k, v in m.items()} for m in metrics],
        "params": {net: {n: p.detach().cpu() for n, p in m.named_parameters()}
                   for net, m in nets.items()},
        "grads": {net: {n: p.grad.cpu() for n, p in m.named_parameters()}
                  for net, m in nets.items()},
        "opt": [state.opt_g.state_dict(), state.opt_d.state_dict()],
    }


def step_rank(device, root: str, accum: int, zero: bool, steps: int) -> None:
    """A rank's ``run_steps`` on ``root``'s case, written to ``rank{r}.pt``."""
    case = torch.load(Path(root) / "case.pt", weights_only=False)
    out = run_steps(case, accum, zero, steps)
    torch.save(out, Path(root) / f"rank{pdist.rank()}.pt")


def train_rank(device, cfg: dict, save_path: str, root: str, zero: bool) -> None:
    """``trainer.train`` as one rank; its final parameters, its tracker's log
    file and its metrics to ``rank{r}.pt``."""
    torch.set_num_threads(1)
    state = trainer.train(cfg, save_path, device=device, zero=zero)
    ts = state.train_state
    torch.save({"params": {f"{net}.{n}": p.detach().clone()
                           for net, m in (("generator", ts.generator),
                                          ("discriminator", ts.discriminator))
                           for n, p in m.named_parameters()},
                "log_file": state.tracker.log_file, "metrics": state.metrics},
               Path(root) / f"rank{pdist.rank()}.pt")


def init_rank(device, root: str, port_: int) -> None:
    """This rank's (rank, world) as torchrun's environment made it, then as
    JAX's multi-host flags make it, in a second group (a host of one CPU
    process a rank), to ``rank{r}.pt``."""
    import torch.distributed as dist

    env_view = (dist.get_rank(), dist.get_world_size())
    dist.destroy_process_group()
    pdist.init_distributed("gloo", coordinator=f"localhost:{port_}",
                           num_processes=env_view[1], process_id=env_view[0],
                           local_rank=0, device="cpu")
    flag_view = (dist.get_rank(), dist.get_world_size())
    torch.save({"env": env_view, "flags": flag_view},
               Path(root) / f"rank{env_view[0]}.pt")
