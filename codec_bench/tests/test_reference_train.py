"""One train step of the plain reference against vrvq_tpu_torch's
``train_step`` at a small configuration on the CPU, from the same weights,
batch and pinned levels: the losses, and every parameter after the step."""

import pytest
import torch

from codec_bench import weights
from codec_bench.drivers import train as train_driver
from codec_bench.reference.codec import Codec
from codec_bench.reference.train import Discriminator, TrainStep
from codec_bench.tests.helpers import TINY, cell_run

KEYS = TINY["keys"]


@pytest.fixture(scope="module")
def stepped():
    run = cell_run("vrvq_a2.train_b16", seed=21, drive=False)
    feed = train_driver.Feed(run, torch.device("cpu"))
    audio, levels = feed.step(0)
    gen = weights.draw(Codec(KEYS), 21, 0)
    disc = weights.draw(Discriminator(KEYS), 21, 2)
    host_g, host_d = weights.host_state(gen), weights.host_state(disc)
    state = train_driver._program(run, host_g, host_d, torch.device("cpu"))
    out = state.train_step(state.train_state, audio, levels=levels, depths=[])
    ref = TrainStep(gen, disc, KEYS)
    ref_out = ref.step(audio, levels)
    return state, out, gen, disc, ref_out


def test_losses(stepped):
    _, out, _, _, ref_out = stepped
    for key in ("loss", "adv/disc_loss"):
        assert abs(float(out[key]) - ref_out[key]) <= 1e-5 * abs(ref_out[key])


@pytest.mark.parametrize("net", ["generator", "discriminator"])
def test_parameters_after_one_step(stepped, net):
    state, _, gen, disc, _ = stepped
    n_enc, n_dec = (len(KEYS[f"DAC_VRVQ.{k}_rates"]) for k in ("encoder", "decoder"))
    module = getattr(state.train_state, net)
    ref = (gen if net == "generator" else disc).state_dict()
    worst = 0.0
    for key, p in module.named_parameters():
        name = (train_driver.reference_name(key, n_enc, n_dec) if net == "generator"
                else train_driver.disc_reference_name(key, module.names))
        r = ref[name]
        a, b = torch.linalg.vector_norm(p.detach()), torch.linalg.vector_norm(r)
        worst = max(worst, float(abs(a - b) / b.clamp(min=1e-12)))
    assert worst < 1e-4
