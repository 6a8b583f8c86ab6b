"""Configuration: the YAML files of ``conf/``, their ``$include`` chains and
scopes, the command line, and the model's configuration.

Counterpart of ``vrvq_tpu/config.py``. ``Config.load("conf/<exp>.yml")``
gives the merged flat mapping of dotted binding keys
(``DAC_VRVQ.n_codebooks``), scoped keys (``train/AudioDataset.duration``,
read under ``cfg.scope("train")``) and plain keys (``batch_size``,
``lambdas`` kept as a dict); ``parse_args`` reads ``--args.load conf/x.yml``
plus ``--key value`` overrides. ``model_config`` reads a ``ModelConfig``
out of it; ``FLAGSHIP`` is the flagship's (``conf/vrvq/vrvq_a2.yml``:
81.56M parameters, 8 codebooks of 1024 x 8).

The card's machine has no PyYAML, so the files are read by ``parse_yaml``,
a reader of the subset of YAML that ``conf/`` is written in: block mappings
and lists, flow lists (nested too), plain and quoted scalars, comments. Its
scalars resolve as PyYAML's ``safe_load`` resolves them (YAML 1.1: ``null``
and ``~``, ``true``/``yes``/``on`` and their opposites, decimal integers,
floats with a dot such as ``1.0e-5``). Anything else raises rather than be
misread: anchors and aliases, tags, block scalars, flow mappings, multiple
documents, and plain scalars that look like numbers PyYAML reads otherwise
(``1e-5`` is a string there, ``010`` an octal integer, ``.inf`` a float,
``2001-12-14`` a date).
"""

from __future__ import annotations

import ast
import copy
import dataclasses
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union

# ------------------------------------------------------------------ YAML

_NULL = {"null", "Null", "NULL", "~", ""}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.[0-9]+(?:[eE][-+][0-9]+)?")
_NUMBERISH = re.compile(r"[-+]?\.?[0-9]|[-+]?\.(inf|nan)$", re.IGNORECASE)


class YAMLError(ValueError):
    """A file outside the YAML subset that ``parse_yaml`` reads."""


def _scalar(text: str, where: str) -> Any:
    """A plain scalar, resolved as PyYAML's YAML 1.1 resolver does."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if _NUMBERISH.match(text):
        raise YAMLError(f"{where}: {text!r} looks like a number in a form "
                        "this reader does not resolve (write e.g. 1.0e-5)")
    if text[0] in "&*!|>{}%@`\"'" or ": " in text or text.endswith(":"):
        raise YAMLError(f"{where}: unsupported YAML in {text!r}")
    return text


def _quoted(text: str, i: int, where: str) -> Tuple[str, int]:
    """The quoted string starting at ``text[i]``; returns it and the index
    after its closing quote."""
    quote = text[i]
    out = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if quote == "'" and c == "'":
            if text[j + 1: j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if quote == '"' and c == "\\":
            esc = text[j + 1: j + 2]
            table = {'"': '"', "\\": "\\", "n": "\n", "t": "\t", "/": "/"}
            if esc not in table:
                raise YAMLError(f"{where}: unsupported escape \\{esc}")
            out.append(table[esc])
            j += 2
            continue
        if quote == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise YAMLError(f"{where}: unterminated quoted string")


def _flow(text: str, i: int, where: str) -> Tuple[list, int]:
    """The flow list starting at ``text[i] == '['``, nested lists included;
    returns it and the index after its ``]``."""
    items: list = []
    j = i + 1
    expect_item = True
    while True:
        while j < len(text) and text[j] == " ":
            j += 1
        if j >= len(text):
            raise YAMLError(f"{where}: a flow list must close on its line")
        c = text[j]
        if c == "]":
            return items, j + 1
        if c == ",":
            if expect_item:
                raise YAMLError(f"{where}: empty item in a flow list")
            expect_item = True
            j += 1
            continue
        if not expect_item:
            raise YAMLError(f"{where}: expected ',' or ']' in a flow list")
        if c == "[":
            value, j = _flow(text, j, where)
        elif c in "\"'":
            value, j = _quoted(text, j, where)
        elif c == "{":
            raise YAMLError(f"{where}: flow mappings are not supported")
        else:
            k = j
            while k < len(text) and text[k] not in ",[]{}":
                k += 1
            value, j = _scalar(text[j:k].strip(), where), k
        items.append(value)
        expect_item = False


def _inline(text: str, where: str) -> Any:
    """The value written after ``key:`` or ``- ``."""
    if text[0] == "[":
        value, end = _flow(text, 0, where)
    elif text[0] in "\"'":
        value, end = _quoted(text, 0, where)
    else:
        return _scalar(text, where)
    if text[end:].strip():
        raise YAMLError(f"{where}: unexpected text after a value: {text[end:]!r}")
    return value


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after a blank,
    outside quotes."""
    quote = None
    for j, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "\"'" and (j == 0 or line[j - 1] in " [,:-"):
            quote = c
        elif c == "#" and (j == 0 or line[j - 1] in " \t"):
            return line[:j]
    return line


def _split_key(content: str, where: str) -> Tuple[str, str]:
    if content[0] in "\"'":
        key, end = _quoted(content, 0, where)
        rest = content[end:]
        if not rest.startswith(":"):
            raise YAMLError(f"{where}: expected ':' after a quoted key")
        return key, rest[1:].strip()
    m = re.match(r"([^\s:][^:]*?)\s*:(?:\s+(.*))?$", content)
    if not m or m.group(1)[0] in "&*!|>{[%@`-?":
        raise YAMLError(f"{where}: expected 'key: value', got {content!r}")
    return m.group(1), (m.group(2) or "").strip()


def parse_yaml(text: str, name: str = "<yaml>") -> Any:
    """The document in ``text`` (see the module docstring for the subset)."""
    lines = []
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        body = line.lstrip(" ")
        if body[0] == "\t" or "\t" in line[: len(line) - len(body)]:
            raise YAMLError(f"{name}:{n}: tabs in indentation")
        if body.startswith(("---", "...", "%")):
            raise YAMLError(f"{name}:{n}: directives and multiple documents "
                            "are not supported")
        lines.append((len(line) - len(body), body, f"{name}:{n}"))

    def is_item(body: str) -> bool:
        return body == "-" or body.startswith("- ")

    def block(i: int, indent: int):
        if is_item(lines[i][1]):
            return sequence(i, indent)
        return mapping(i, indent)

    def nested(i: int, indent: int, allow_same_seq: bool):
        """The block after a bare ``key:`` or ``-`` at ``indent``: deeper,
        or (after a key) a list at the same indent; else null."""
        if i < len(lines):
            nxt_indent, nxt_body, _ = lines[i]
            if nxt_indent > indent:
                return block(i, nxt_indent)
            if allow_same_seq and nxt_indent == indent and is_item(nxt_body):
                return sequence(i, indent)
        return None, i

    def mapping(i: int, indent: int):
        out: Dict[str, Any] = {}
        while i < len(lines) and lines[i][0] == indent and not is_item(lines[i][1]):
            _, body, where = lines[i]
            key, rest = _split_key(body, where)
            if rest:
                out[key] = _inline(rest, where)
                i += 1
            else:
                out[key], i = nested(i + 1, indent, allow_same_seq=True)
        if i < len(lines) and lines[i][0] > indent:
            raise YAMLError(f"{lines[i][2]}: unexpected indentation")
        return out, i

    def sequence(i: int, indent: int):
        out: list = []
        while i < len(lines) and lines[i][0] == indent and is_item(lines[i][1]):
            _, body, where = lines[i]
            rest = body[1:].strip()
            if not rest:
                value, i = nested(i + 1, indent, allow_same_seq=False)
                out.append(value)
                continue
            if re.match(r"[^\s\"'\[][^:]*:(\s|$)", rest):
                raise YAMLError(f"{where}: mappings inside block lists are "
                                "not supported")
            out.append(_inline(rest, where))
            i += 1
        if i < len(lines) and lines[i][0] > indent:
            raise YAMLError(f"{lines[i][2]}: unexpected indentation")
        return out, i

    if not lines:
        return None
    value, i = block(0, lines[0][0])
    if i < len(lines):
        raise YAMLError(f"{lines[i][2]}: unexpected indentation")
    return value


# ---------------------------------------------------------------- Config


class Config:
    """A flat mapping of dotted config keys with scope-aware lookup: under
    ``scope("train")``, ``train/X`` is read in place of ``X``."""

    def __init__(self, values: Optional[Dict[str, Any]] = None):
        self._values: Dict[str, Any] = dict(values or {})
        self._scopes: List[str] = []

    @classmethod
    def load(cls, path, overrides: Optional[Dict[str, Any]] = None,
             base_dir=None) -> "Config":
        """Load a YAML file, its ``$include`` list first (in order, each
        later file winning, the including file last). An include is looked
        up under ``base_dir``, then as given, then under every ancestor of
        the including file."""
        p = Path(path)
        if not p.exists() and base_dir is not None and not p.is_absolute():
            p = Path(base_dir) / p
        values = cls._load_file(p, base_dir)
        if overrides:
            values.update(overrides)
        return cls(values)

    @staticmethod
    def _load_file(path: Path, base_dir) -> Dict[str, Any]:
        raw = parse_yaml(path.read_text(), str(path)) or {}
        if not isinstance(raw, dict):
            raise ValueError(f"Config file {path} must be a mapping")
        includes = raw.pop("$include", []) or []
        merged: Dict[str, Any] = {}
        for inc in includes:
            candidates = [Path(base_dir) / inc] if base_dir is not None else []
            candidates.append(Path(inc))
            candidates += [ancestor / inc for ancestor in path.resolve().parents]
            found = next((c for c in candidates if c.exists()), None)
            if found is None:
                raise FileNotFoundError(f"$include {inc} (from {path}) not found")
            merged.update(Config._load_file(found, base_dir))
        merged.update(raw)
        return merged

    def __getitem__(self, key: str) -> Any:
        for scope in reversed(self._scopes):
            if f"{scope}/{key}" in self._values:
                return self._values[f"{scope}/{key}"]
        return self._values[key]

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    def __contains__(self, key: str) -> bool:
        try:
            self[key]
        except KeyError:
            return False
        return True

    def __setitem__(self, key: str, value: Any) -> None:
        self._values[key] = value

    def update(self, other: Dict[str, Any]) -> None:
        self._values.update(other)

    def kwargs(self, prefix: str) -> Dict[str, Any]:
        """``{prefix}.{name}`` keys as kwargs, ``{scope}/{prefix}.{name}``
        over them for every active scope (innermost last)."""
        out = {k[len(prefix) + 1:]: v for k, v in self._values.items()
               if k.startswith(prefix + ".")}
        for scope in self._scopes:
            want = f"{scope}/{prefix}."
            out.update({k[len(want):]: v for k, v in self._values.items()
                        if k.startswith(want)})
        return copy.deepcopy(out)

    def scope(self, name: str) -> "_Scope":
        return _Scope(self, name)

    @property
    def active_scopes(self) -> Tuple[str, ...]:
        return tuple(self._scopes)

    def to_dict(self) -> Dict[str, Any]:
        return dict(self._values)


class _Scope:
    def __init__(self, cfg: Config, name: str):
        self.cfg, self.name = cfg, name

    def __enter__(self) -> Config:
        self.cfg._scopes.append(self.name)
        return self.cfg

    def __exit__(self, *exc) -> None:
        self.cfg._scopes.pop()


def _parse_cli_value(text: str) -> Any:
    """A command-line value: a Python literal if it is one, else
    ``true``/``false``/``null``/``none`` (any case), else the string."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        lowered = text.lower()
        if lowered in ("true", "false"):
            return lowered == "true"
        if lowered in ("null", "none"):
            return None
        return text


def parse_args(argv: Optional[Iterable[str]] = None, base_dir=None) -> Config:
    """``--args.load conf.yml`` plus ``--key value`` (or ``--key=value``, or a
    bare ``--flag`` for true) overrides, as ``scripts/train.py`` takes them."""
    argv = list(sys.argv[1:] if argv is None else argv)
    load_path = None
    overrides: Dict[str, Any] = {}
    i = 0
    while i < len(argv):
        arg = argv[i]
        if not arg.startswith("--"):
            raise ValueError(f"Unexpected positional argument: {arg}")
        key = arg[2:]
        if "=" in key:
            key, text = key.split("=", 1)
            value = _parse_cli_value(text)
            i += 1
        elif i + 1 < len(argv) and not argv[i + 1].startswith("--"):
            value = _parse_cli_value(argv[i + 1])
            i += 2
        else:
            value = True
            i += 1
        if key == "args.load":
            load_path = value
        else:
            overrides[key] = value
    if load_path is not None:
        return Config.load(load_path, overrides=overrides, base_dir=base_dir)
    return Config(overrides)


# ----------------------------------------------------------- the model


@dataclass(frozen=True)
class ModelConfig:
    """The ``DAC_VRVQ.*`` keys the port builds a codec from. ``model_type``
    is ``VBR`` (importance-masked stages) or ``CBR`` (the constant-bitrate
    quantizer with quantizer dropout). ``codebook_dim`` is one width for
    every stage or a tuple of one a stage; ``latent_dim`` is the encoder's
    output width (None: it doubles at every stride, ``resolved_latent_dim``).
    The two ``snake_approx`` fields train and run that stack with the
    polynomial Snake; ``detach_imp_map_input`` stops the importance subnet's
    gradient at its input. ``compute_dtype`` is the conv stacks' dtype when
    serving (``float32`` or ``bfloat16``; the quantizer stays float32, as in
    the JAX model): ``infer/fast.serving_model`` maps it onto a ``Profile``,
    and training takes float32 only. ``encoder_packed``, ``decoder_packed``
    and ``decoder_packed_up`` run the first encoder stage, the last decoder
    blocks with the tail, or only those blocks' transposed convs in the
    time-packed layout (``nn/layers.py``): the same function of the same
    parameters, on the padded codec only."""

    sample_rate: int = 44100
    encoder_dim: int = 64
    encoder_rates: Tuple[int, ...] = (2, 4, 8, 8)
    latent_dim: Optional[int] = None
    decoder_dim: int = 1536
    decoder_rates: Tuple[int, ...] = (8, 8, 4, 2)
    n_codebooks: int = 8
    codebook_size: int = 1024
    codebook_dim: Union[int, Tuple[int, ...]] = 8
    model_type: str = "VBR"
    level_min: float = 0.125
    level_max: float = 6.0
    level_dist: str = "uniform"
    imp2mask_alpha: float = 2.0
    # the train-mode batch partition (vrvq_a2.yml: 0.25 full-codebook rows,
    # no random-depth rows)
    full_codebook_rate: float = 0.25
    quantizer_dropout: float = 0.0
    detach_imp_map_input: bool = False
    encoder_snake_approx: bool = False
    decoder_snake_approx: bool = False
    compute_dtype: str = "float32"
    encoder_packed: bool = False
    decoder_packed: int = 0
    decoder_packed_up: int = 0

    def __post_init__(self):
        if self.model_type not in ("VBR", "CBR"):
            raise ValueError(f"Invalid RVQ model_type: {self.model_type!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                             f"{self.compute_dtype!r}")
        if not isinstance(self.codebook_dim, int):  # a YAML list: hashable
            object.__setattr__(self, "codebook_dim", tuple(self.codebook_dim))

    @property
    def feature_dim(self) -> int:
        """The width of the encoder's feature, after its last block (it
        doubles at every stride)."""
        return self.encoder_dim * (2 ** len(self.encoder_rates))

    @property
    def resolved_latent_dim(self) -> int:
        """The encoder's output width: ``latent_dim``, else
        ``feature_dim``."""
        return self.feature_dim if self.latent_dim is None else self.latent_dim


FLAGSHIP = ModelConfig()
# the flagship's training configuration, from the repo root
FLAGSHIP_YAML = "conf/vrvq/vrvq_a2.yml"
REPO = Path(__file__).resolve().parents[1]


def model_config(cfg: Config) -> ModelConfig:
    """The ``ModelConfig`` of a config's ``DAC_VRVQ.*`` keys; a key that the
    port does not implement raises with its name."""
    kw = cfg.kwargs("DAC_VRVQ")
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(kw) - fields)
    if unknown:
        raise NotImplementedError(
            f"DAC_VRVQ keys the port does not implement: "
            f"{['DAC_VRVQ.' + k for k in unknown]}")
    for key in ("encoder_rates", "decoder_rates"):
        if key in kw:
            kw[key] = tuple(kw[key])
    return ModelConfig(**kw)  # a codebook_dim list becomes a tuple there


def small_config(**overrides) -> ModelConfig:
    """The flagship's topology at test widths (encoder 16, decoder 128,
    4 codebooks of 64 x 4), with any field overridden."""
    base = ModelConfig(encoder_dim=16, decoder_dim=128, n_codebooks=4,
                       codebook_size=64, codebook_dim=4)
    return dataclasses.replace(base, **overrides)
