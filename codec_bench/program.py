"""The system under test, built from the benchmark's weights: the only
module of the harness that imports ``vrvq_tpu_torch``.

The port gets the reference-layout tensors through its own converters
(``convert.state_dict_from_reference``, ``discriminator_state_dict_from_
reference``) and the configuration file's keys through its own config
reader (``config.Config``, ``config.model_config``)."""

from __future__ import annotations

import torch

import vrvq_tpu_torch as port
from vrvq_tpu_torch import convert
from vrvq_tpu_torch.config import Config, model_config
from vrvq_tpu_torch.models.dac_vrvq import DAC_VRVQ


def config(keys: dict) -> Config:
    return Config(dict(keys))


def codec(keys: dict, ref_state: dict, device) -> DAC_VRVQ:
    """The live codec of ``keys`` on ``device`` with the reference-layout
    weights ``ref_state`` (host tensors)."""
    cfg = model_config(config(keys))
    with torch.device("meta"):
        shapes = DAC_VRVQ(cfg)
    state = convert.state_dict_from_reference(ref_state, shapes)
    return port.build_model(cfg, device=device, state_dict=state)


def load_generator(model, ref_state: dict) -> None:
    """Copy reference-layout weights into a live codec in place."""
    state = convert.state_dict_from_reference(ref_state, model)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(state[k])


def load_discriminator(disc, ref_state: dict) -> None:
    state = convert.discriminator_state_dict_from_reference(ref_state, disc)
    with torch.no_grad():
        for k, v in disc.state_dict().items():
            v.copy_(state[k])
