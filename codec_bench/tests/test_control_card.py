"""The controls, on the card at a small size: the reference at the next
lower precision in the program's place (TF32 for the float32 stacks, fp8
for the bfloat16 decoder) fails the cell's comparison. The readings at each
cell's own size come from ``python3 -m codec_bench.readings --impl
control``; see ``PERF.md``. Marked ``cuda``: skips without a card."""

import pytest

from codec_bench import harness
from codec_bench.tests.helpers import cell_run

pytestmark = pytest.mark.cuda

CELLS = [w["name"] for w in harness.spec()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(card, workload):
    run = cell_run(workload, drive=False, impl="control")
    run.device = "cuda"
    run.config = harness.read_json("configs", harness.cell(workload)["config"])
    harness.driver(run.mix["driver"]).drive(run)
    assert not run.correct, run.checks
