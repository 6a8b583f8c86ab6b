"""vrvq_tpu_torch: the PyTorch + CUDA port of the vrvq_tpu codec.

Serving path: ``build_model`` -> ``CodecProcessor(model,
fused_quantizer=True).compress(...)`` -> ``DACFile.save/load`` ->
``decompress(...)``; the fast and turbo profiles in ``infer/fast.py``,
chunked, streaming and pooled serving in ``infer/chunked.py`` and
``infer/streaming.py``, the level sweep in ``infer/sweep.py``. The Snake
activation and the fused residual VQ run as hand-written CUDA kernels on the
card (``kernels/csrc``); on the CPU, which the tests use, their plain
PyTorch versions run instead.

Entry points run on the card unless the caller asks for ``device="cpu"``;
without CUDA they raise rather than fall back.
"""

from __future__ import annotations

import contextlib
import os
from typing import Mapping, Optional, Union

# cuBLAS repeats its bits run to run only with a fixed workspace setting,
# read when its first handle is made (PyTorch's deterministic mode asks for
# it too): set before any cuBLAS call of the process, unless already set.
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device to run on; a CUDA device when CUDA is absent raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def disable_tf32() -> None:
    """Full float32 in matmuls and convs on the card: TF32 keeps ~3 decimal
    digits and flips codebook argmaxes. The counterpart of the JAX package's
    precision='highest' on the codes path."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@contextlib.contextmanager
def deterministic_cudnn():
    """A context in which cuDNN runs only its deterministic algorithms,
    picked by its heuristics rather than by timing them (two processes could
    time them differently). The train and validation steps run in it, so a
    step is a function of its inputs, as XLA's is: run twice, or resumed, it
    gives the same bits. Scoped rather than set for the process: serving
    keeps cuDNN's own choice (a decoder's transposed convs run its
    backward-data algorithms), whatever trained before it in the process."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


from .audio import Signal, synthetic_clip  # noqa: E402
from .config import FLAGSHIP, ModelConfig, small_config  # noqa: E402
from .convert import init_params, state_dict_from_jax  # noqa: E402
from .infer.codec_api import CodecProcessor  # noqa: E402
from .models.codec import DACFile  # noqa: E402
from .models.dac_moe import DAC_MOE  # noqa: E402
from .models.dac_vrvq import DAC_VRVQ  # noqa: E402


def build_model(config: ModelConfig = FLAGSHIP, *,
                device: Union[str, torch.device] = "cuda",
                state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                seed: int = 0, model_class: type = DAC_VRVQ) -> DAC_VRVQ:
    """A codec (``DAC_VRVQ``, or ``model_class=DAC_MOE``) of ``config`` in
    eval mode on ``device``: with ``state_dict`` loaded (strict), else drawn
    by ``init_params`` from ``seed``. Live, or with ``compute_dtype:
    bfloat16`` both conv stacks folded into bfloat16
    (``infer/fast.serving_model``)."""
    from .infer.fast import serving_model

    device = resolve_device(device)
    disable_tf32()
    model = model_class(config)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    else:
        init_params(model, torch.Generator().manual_seed(seed))
    return serving_model(model.to(device).eval(), fast=False)


__all__ = [
    "CodecProcessor", "DACFile", "DAC_MOE", "DAC_VRVQ", "FLAGSHIP", "ModelConfig",
    "Signal", "build_model", "deterministic_cudnn", "disable_tf32", "init_params",
    "resolve_device", "small_config", "state_dict_from_jax", "synthetic_clip",
]
