"""The check that no run loaded JAX or the JAX package compares each
module's top-level name whole, and a run on a machine without CUDA prints
no result."""

import subprocess
import sys
import types

import pytest

from codec_bench import harness


@pytest.mark.parametrize("name,caught", [
    ("vrvq_tpu_torch.models", False), ("vrvq_tpu_torchx", False),
    ("vrvq_tpu", True), ("vrvq_tpu.models.codec", True), ("jaxlib.xla_client", True),
    ("jax", True), ("flax.linen", True), ("jaxtyping", False), ("flaxen", False),
])
def test_top_level_names(name, caught, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in harness.forbidden_modules()) == caught


def test_harness_loads_neither():
    code = ("import sys, codec_bench.run, codec_bench.readings, codec_bench.program; "
            "import codec_bench.drivers.oneshot, codec_bench.drivers.live, "
            "codec_bench.drivers.train; from codec_bench import harness; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "codec_bench.run", "--workload",
                          harness.spec()["workloads"][0]["name"], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=harness.REPO,
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
