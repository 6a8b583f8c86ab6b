"""The port's configuration against the JAX package's: every YAML file of
``conf/`` loads to the same keys and values (``$include`` chains, scopes,
``kwargs``), the command line parses alike, the reader refuses YAML outside
its subset, and the port reads the files without PyYAML."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from vrvq_tpu.config import Config as JaxConfig
from vrvq_tpu.config import parse_args as jax_parse_args
from vrvq_tpu_torch import config as tconfig
from vrvq_tpu_torch.config import Config, YAMLError, parse_args, parse_yaml

REPO = Path(__file__).resolve().parents[1]
CONF_FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / "conf").rglob("*.yml"))
SCOPES = ("train", "val", "test")


def _bindings(values):
    return sorted({k.split("/")[-1].split(".")[0] for k in values if "." in k})


def test_conf_holds_every_config():
    assert len(CONF_FILES) == 15, CONF_FILES


@pytest.mark.parametrize("path", CONF_FILES)
def test_load_equals_jax(path):
    ours = Config.load(path, base_dir=REPO)
    theirs = JaxConfig.load(path, base_dir=REPO)
    assert ours.to_dict() == theirs.to_dict()
    for k, v in ours.to_dict().items():  # ints stay ints, floats floats
        assert type(v) is type(theirs.to_dict()[k]), k
    assert ours.kwargs("DAC_VRVQ") == theirs.kwargs("DAC_VRVQ")
    names = sorted({k.split("/", 1)[-1] for k in ours.to_dict()})
    for scope in SCOPES:
        with ours.scope(scope), theirs.scope(scope):
            for prefix in _bindings(ours.to_dict()):
                assert ours.kwargs(prefix) == theirs.kwargs(prefix), (scope, prefix)
            for name in names:
                assert ours.get(name, "missing") == theirs.get(name, "missing"), (
                    scope, name)


@pytest.mark.parametrize("argv", [
    ["--args.load", "conf/vrvq/vrvq_a2.yml", "--batch_size=16", "--resume",
     "--save_iters", "[10, 20]", "--tag", "null"],
    ["--args.load=conf/original_dac/cbr.yml", "--train/AudioDataset.duration",
     "0.5", "--DAC_VRVQ.n_codebooks", "4", "--save_path", "runs/a"],
    ["--lambdas", "{'mel/loss': 1.0}", "--overwrite_ok", "True", "--seed", "3",
     "--device", "cpu", "--flag"],
], ids=["load-eq-flag-list-null", "eq-load-scoped", "no-load-dict"])
def test_parse_args_equals_jax(argv):
    assert (parse_args(argv, base_dir=REPO).to_dict()
            == jax_parse_args(argv, base_dir=REPO).to_dict())


@pytest.mark.parametrize("text", [
    "a: &anchor 1\nb: *anchor\n", "a: |\n  block\n", "a: >\n  folded\n",
    "a: {b: 1}\n", "a: !!str 1\n", "a: 1e-5\n", "a: [1, 2\n", "---\na: 1\n",
    "a:\n  - b: 1\n",
], ids=["anchor", "block-scalar", "folded-scalar", "flow-mapping", "tag",
        "bare-exponent", "open-flow-list", "document-marker", "list-of-maps"])
def test_reader_raises_outside_its_subset(text):
    with pytest.raises(YAMLError):
        parse_yaml(text)


def test_reader_nested_flow_lists_and_scalars():
    text = textwrap.dedent("""\
        # a comment
        a: [[0.0, 0.1], [1, "x, y"], []]  # trailing
        b:
          - [null, ~, yes, Off]
          - 'it''s'
        c:
          d:
            - e
        f: 1.0e-5
        g:
        """)
    assert parse_yaml(text) == {
        "a": [[0.0, 0.1], [1, "x, y"], []],
        "b": [[None, None, True, False], "it's"],
        "c": {"d": ["e"]}, "f": 1.0e-5, "g": None}


def test_model_config_of_every_config():
    for path in CONF_FILES:
        cfg = Config.load(path, base_dir=REPO)
        if "DAC_VRVQ.encoder_dim" in cfg.to_dict():
            tconfig.model_config(cfg)
    flagship = Config.load(tconfig.FLAGSHIP_YAML, base_dir=REPO)
    assert tconfig.model_config(flagship) == tconfig.FLAGSHIP
    cbr = tconfig.model_config(Config.load("conf/original_dac/cbr.yml", base_dir=REPO))
    assert (cbr.model_type, cbr.quantizer_dropout) == ("CBR", 0.5)
    fast = tconfig.model_config(Config.load("conf/vrvq/vrvq_a2_fast.yml", base_dir=REPO))
    assert fast.encoder_snake_approx and fast.decoder_snake_approx
    wide = tconfig.model_config(Config({**flagship.to_dict(), "DAC_VRVQ.latent_dim": 512}))
    assert (wide.latent_dim, wide.resolved_latent_dim) == (512, 512)
    packed = tconfig.model_config(Config({**flagship.to_dict(),
                                          "DAC_VRVQ.encoder_packed": True,
                                          "DAC_VRVQ.decoder_packed": 2}))
    assert (packed.encoder_packed, packed.decoder_packed, packed.decoder_packed_up) == (
        True, 2, 0)
    with pytest.raises(NotImplementedError, match="DAC_VRVQ.encoder_packing"):
        tconfig.model_config(Config({**flagship.to_dict(),
                                     "DAC_VRVQ.encoder_packing": True}))


BLOCKED_YAML = textwrap.dedent("""
    import sys
    class Block:
        @staticmethod
        def find_spec(name, path=None, target=None):
            if name.split(".")[0] == "yaml":
                raise ImportError("blocked import of " + name)
            return None
    sys.meta_path.insert(0, Block)
    from pathlib import Path
    from vrvq_tpu_torch.config import Config
    n = 0
    for p in sorted(Path("conf").rglob("*.yml")):
        Config.load(p)
        n += 1
    assert "yaml" not in sys.modules
    print("loaded", n)
""")


def test_config_reads_every_file_without_pyyaml():
    proc = subprocess.run([sys.executable, "-c", BLOCKED_YAML], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.split() == ["loaded", str(len(CONF_FILES))]
