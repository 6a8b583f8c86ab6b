"""Each configuration file holds the keys of the conf/ file it names, as
the port's own reader resolves them."""

import json

import pytest

from codec_bench import harness
from vrvq_tpu_torch.config import Config

CONFIGS = harness.spec()["configs"]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: c["name"])
def test_keys_agree_with_conf(cfg):
    data = json.loads((harness.REPO / cfg["file"]).read_text())
    resolved = Config.load(data["conf"], base_dir=str(harness.REPO))._values
    assert data["keys"] == json.loads(json.dumps(resolved))
    assert data["reduced"] == [] and data["assumed"] == []
