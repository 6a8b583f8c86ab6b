"""Codec plumbing: conv-graph length arithmetic and the ``.dac`` bitstream.

The port's own copy of ``vrvq_tpu/models/codec.py``: the ``ConvSpec`` walk that
gives the padding-free codec's delay and output lengths, the VBR code packing
and the ``DACFile`` format, so that the same codes give the same bytes in both
packages, in every format: plain, bit-packed and range-coded
(``entropy=True``, ``ops/rangecoder.py``). Pure Python and numpy.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

from ..ops.rangecoder import decode_adaptive, encode_adaptive

SUPPORTED_VERSIONS = ["1.0.0"]


@dataclass(frozen=True)
class ConvSpec:
    """One conv layer for length arithmetic. kind: 'conv' | 'convT'."""

    kind: str
    kernel: int
    stride: int = 1
    dilation: int = 1


def output_length(layers: Sequence[ConvSpec], input_length: int) -> int:
    """Padding-free output length of the conv chain
    (reference: models/dac_base.py:112-127)."""
    L = input_length
    for layer in layers:
        d, k, s = layer.dilation, layer.kernel, layer.stride
        if layer.kind == "conv":
            L = ((L - d * (k - 1) - 1) / s) + 1
        elif layer.kind == "convT":
            L = (L - 1) * s + d * (k - 1) + 1
        else:
            raise ValueError(layer.kind)
        L = math.floor(L)
    return L


def delay(layers: Sequence[ConvSpec]) -> int:
    """Receptive delay of the padding-free codec
    (reference: models/dac_base.py:86-110)."""
    l_out = output_length(layers, 0)
    L = l_out
    for layer in reversed(layers):
        d, k, s = layer.dilation, layer.kernel, layer.stride
        if layer.kind == "convT":
            L = ((L - d * (k - 1) - 1) / s) + 1
        elif layer.kind == "conv":
            L = (L - 1) * s + d * (k - 1) + 1
        L = math.ceil(L)
    l_in = L
    return (l_in - l_out) // 2


def _residual_unit_specs(dilation: int) -> List[ConvSpec]:
    return [
        ConvSpec("conv", 7, 1, dilation),
        ConvSpec("conv", 1, 1, 1),
    ]


def encoder_conv_specs(strides: Sequence[int]) -> List[ConvSpec]:
    """Conv walk of the Encoder (reference: models/dac_vrvq.py:19-48)."""
    specs: List[ConvSpec] = [ConvSpec("conv", 7)]
    for stride in strides:
        for dilation in (1, 3, 9):
            specs += _residual_unit_specs(dilation)
        specs += [ConvSpec("conv", 2 * stride, stride)]
    specs += [ConvSpec("conv", 3)]
    return specs


def decoder_conv_specs(rates: Sequence[int]) -> List[ConvSpec]:
    """Conv walk of the Decoder (reference: models/dac_vrvq.py:51-80)."""
    specs: List[ConvSpec] = [ConvSpec("conv", 7)]
    for stride in rates:
        specs += [ConvSpec("convT", 2 * stride, stride)]
        for dilation in (1, 3, 9):
            specs += _residual_unit_specs(dilation)
    specs += [ConvSpec("conv", 7)]
    return specs


def quantizer_conv_specs(n_codebooks: int, vbr: bool,
                         n_imp_convs: int = 6) -> List[ConvSpec]:
    """Conv walk of the quantizer in torch ``modules()`` order: per-stage
    in/out 1x1 projections, then (VBR only) the importance subnet's k=3
    convs — the reference's delay walk includes these
    (models/dac_base.py:92-94 walks every nn.Conv1d in the model)."""
    specs: List[ConvSpec] = []
    for _ in range(n_codebooks):
        specs += [ConvSpec("conv", 1), ConvSpec("conv", 1)]
    if vbr:
        specs += [ConvSpec("conv", 3)] * n_imp_convs
    return specs


def decoder_halo_frames(rates: Sequence[int]) -> int:
    """Receptive radius of the decoder in latent frames (rounded up).

    A decoder output sample depends on latent frames within this radius,
    so chunked decoding with a halo of this many frames reproduces the
    one-shot decode bit-exactly away from the clip edges. Derived from the
    decoder topology (reference models/dac_vrvq.py:51-80): in-conv k=7,
    per rate r a transposed conv k=2r (radius <= 1 input frame) + three
    ResidualUnits (k=7, dilation 1/3/9 => radius 3*dil samples at the
    current rate), then a k=7 out conv at sample rate.
    """
    radius = 3.0  # in_conv k=7 at latent rate
    up = 1
    for r in rates:
        radius += 1.0 / up  # transposed conv k=2r stride r
        up *= r
        for dil in (1, 3, 9):
            radius += 3.0 * dil / up  # ResidualUnit k=7 dilated conv
    radius += 3.0 / up  # out_conv k=7 at sample rate
    return math.ceil(radius) + 1


def encoder_halo_frames(strides: Sequence[int]) -> int:
    """Receptive radius of the encoder in LATENT frames (rounded up).

    A latent frame depends on input samples within this radius*hop, so
    chunked encoding with this halo reproduces the one-shot encode exactly
    away from the clip edges. Topology (reference models/dac_vrvq.py:19-48):
    in-conv k=7, per stride s three ResidualUnits (k=7, dil 1/3/9) then a
    strided conv k=2s, finally a k=3 out conv at latent rate.
    """
    radius = 3.0  # in_conv k=7, input rate
    r = 1
    for s in strides:
        radius += (3.0 + 9.0 + 27.0) * r  # ResidualUnits at current rate
        radius += s * r  # strided conv k=2s
        r *= s
    radius += 1.0 * r  # out_conv k=3 at latent rate
    hop = int(np.prod(list(strides)))
    return math.ceil(radius / hop) + 1


def model_conv_specs(
    encoder_rates: Sequence[int],
    decoder_rates: Sequence[int],
    n_codebooks: int,
    vbr: bool,
    n_imp_convs: int = 6,
) -> List[ConvSpec]:
    return (
        encoder_conv_specs(encoder_rates)
        + quantizer_conv_specs(n_codebooks, vbr, n_imp_convs)
        + decoder_conv_specs(decoder_rates)
    )


def pack_vbr_codes(codes: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Drop the masked-off stage codes from a VBR stream.

    codes (B, Nq, T), counts (B, T) -> flat uint16 of length counts.sum(),
    ordered (b, t, stage). This is what makes the ``.dac`` file size
    actually scale with the target level — the reference stores nothing for
    VBR (compress is a stub) and CBR streams are always Nq*T codes.
    """
    codes = np.asarray(codes)
    counts = np.asarray(counts)
    nq = codes.shape[1]
    stage = np.arange(nq).reshape(1, nq, 1)
    mask = stage < counts[:, None, :]
    # (B, T, Nq) order so each frame's kept codes are contiguous
    return codes.transpose(0, 2, 1)[mask.transpose(0, 2, 1)].astype(np.uint16)


def unpack_vbr_codes(packed: np.ndarray, counts: np.ndarray,
                     n_codebooks: int) -> np.ndarray:
    """Inverse of pack_vbr_codes; masked-off positions are 0 (they are
    multiplied out by the stage mask at decode)."""
    counts = np.asarray(counts)
    b, t = counts.shape
    stage = np.arange(n_codebooks).reshape(1, n_codebooks, 1)
    mask = (stage < counts[:, None, :]).transpose(0, 2, 1)  # (B, T, Nq)
    out = np.zeros((b, t, n_codebooks), np.int32)
    out[mask] = np.asarray(packed).astype(np.int32)
    return out.transpose(0, 2, 1)


def pack_bits(values: np.ndarray, bits: int) -> np.ndarray:
    """Pack flat non-negative ints < 2**bits into bytes, LSB-first.

    Codes carry ceil(log2(codebook_size)) bits of information (10 for the
    flagship's 1024 entries) but uint16 storage spends 16 — bit-packing is
    a free 37.5% file-size cut the reference leaves on the table (it
    np.saves uint16, models/dac_base.py:29).
    """
    values = np.asarray(values).reshape(-1).astype(np.uint32)
    if values.size and int(values.max()) >= (1 << bits):
        raise ValueError(f"value {values.max()} does not fit in {bits} bits")
    idx = np.arange(bits, dtype=np.uint32)
    bitmat = ((values[:, None] >> idx[None, :]) & 1).astype(np.uint8)
    return np.packbits(bitmat.reshape(-1), bitorder="little")


def unpack_bits(data: np.ndarray, bits: int, count: int) -> np.ndarray:
    """Inverse of :func:`pack_bits` -> (count,) uint32."""
    flat = np.unpackbits(
        np.asarray(data, np.uint8), bitorder="little"
    )[: count * bits]
    bitmat = flat.reshape(count, bits).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(bits, dtype=np.uint32))
    return (bitmat * weights[None, :]).sum(axis=1, dtype=np.uint32)


def _code_bits(codes_max_plus1: int) -> int:
    return max(1, int(math.ceil(math.log2(max(2, codes_max_plus1)))))


def _kept_stage_contexts(counts: np.ndarray, n_codebooks: int) -> np.ndarray:
    """Stage index of every kept code in ``pack_vbr_codes`` order
    ((b, t, stage)): the range coder's per-stage model contexts."""
    counts = np.asarray(counts)
    stage = np.broadcast_to(
        np.arange(n_codebooks).reshape(1, 1, n_codebooks),
        (*counts.shape, n_codebooks),
    )
    return stage[stage < counts[:, :, None]]


def _stage_contexts(shape) -> np.ndarray:
    """Stage index of every code of a (B, Nq, T) CBR stream, flat."""
    nq = shape[1]
    return np.broadcast_to(np.arange(nq).reshape(1, nq, 1), shape).reshape(-1)


@dataclass
class DACFile:
    """The ``.dac`` bitstream: codes and metadata through ``np.save``.

    The reference's format for CBR (plain uint16), and the JAX package's VBR
    extension: with per-frame codebook counts (``vbr_counts``) only the kept
    stage codes are stored, bit-packed to ceil(log2(codebook_size)) bits, with
    the counts packed to ceil(log2(Nq + 1)) bits. ``compact=True`` bit-packs a
    CBR stream too. ``entropy=True`` range-codes the kept codes with one
    adaptive model per stage (and the counts with one model) in place of
    fixed-width packing; it implies ``compact`` for CBR.
    """

    codes: np.ndarray  # (B, Nq, T) int

    chunk_length: int
    original_length: int
    input_db: float
    channels: int
    sample_rate: int
    padding: bool
    dac_version: str = SUPPORTED_VERSIONS[-1]
    vbr_counts: Union[np.ndarray, None] = None  # (B, T) uint8, codebooks/frame

    def save(self, path, compact: bool = False,
             codebook_size: Optional[int] = None,
             entropy: bool = False) -> Path:
        """``codebook_size`` sets the code width (the range coder's alphabet
        with ``entropy``), by default the smallest width that holds the
        stream's largest index."""
        metadata = {
            "input_db": np.float32(self.input_db),
            "original_length": self.original_length,
            "sample_rate": self.sample_rate,
            "chunk_length": self.chunk_length,
            "channels": self.channels,
            "padding": self.padding,
            "dac_version": self.dac_version,
        }
        codes = np.asarray(self.codes)
        n_sym = int(
            codebook_size if codebook_size is not None
            else (int(codes.max()) + 1 if codes.size else 2)
        )

        if self.vbr_counts is not None and entropy:
            counts = np.asarray(self.vbr_counts).astype(np.uint8)
            nq = int(codes.shape[1])
            kept = pack_vbr_codes(codes, counts)
            artifacts = {
                "codes_rc": np.frombuffer(encode_adaptive(
                    kept, n_sym, _kept_stage_contexts(counts, nq), nq), np.uint8),
                "rc_n_symbols": n_sym,
                "n_codes": int(kept.size),
                "counts_rc": np.frombuffer(
                    encode_adaptive(counts, nq + 1), np.uint8),
                "counts_shape": tuple(counts.shape),
                "n_codebooks": nq,
                "metadata": metadata,
            }
        elif self.vbr_counts is not None:
            counts = np.asarray(self.vbr_counts).astype(np.uint8)
            nq = int(codes.shape[1])
            kept = pack_vbr_codes(codes, counts)
            bits = _code_bits(n_sym)
            cbits = _code_bits(nq + 1)
            artifacts = {
                "codes_bits": pack_bits(kept, bits),
                "code_bits": bits,
                "n_codes": int(kept.size),
                "counts_bits": pack_bits(counts, cbits),
                "count_bits": cbits,
                "counts_shape": tuple(counts.shape),
                "n_codebooks": nq,
                "metadata": metadata,
            }
        elif entropy:
            nq = int(codes.shape[1])
            artifacts = {
                "codes_rc": np.frombuffer(encode_adaptive(
                    codes, n_sym, _stage_contexts(codes.shape), nq), np.uint8),
                "rc_n_symbols": n_sym,
                "n_codes": int(codes.size),
                "codes_shape": tuple(codes.shape),
                "metadata": metadata,
            }
        elif compact:
            bits = _code_bits(n_sym)
            artifacts = {
                "codes_bits": pack_bits(codes, bits),
                "code_bits": bits,
                "n_codes": int(codes.size),
                "codes_shape": tuple(codes.shape),
                "metadata": metadata,
            }
        else:
            artifacts = {
                "codes": codes.astype(np.uint16),
                "metadata": metadata,
            }
        path = Path(path).with_suffix(".dac")
        with open(path, "wb") as f:
            np.save(f, artifacts)
        return path

    @classmethod
    def load(cls, path) -> "DACFile":
        # np.load unpickles: open only .dac files this codec or the JAX
        # package wrote
        artifacts = np.load(path, allow_pickle=True)[()]
        metadata = dict(artifacts["metadata"])
        if metadata.get("dac_version", None) not in SUPPORTED_VERSIONS:
            raise RuntimeError(
                f"Given file {path} can't be loaded with this version of "
                "vrvq_tpu_torch."
            )
        metadata["input_db"] = float(metadata["input_db"])
        vbr_counts = artifacts.get("vbr_counts", None)
        if "codes_rc" in artifacts:
            # range-coded
            n_sym = int(artifacts["rc_n_symbols"])
            n_codes = int(artifacts["n_codes"])
            if "counts_rc" in artifacts:
                shape = tuple(artifacts["counts_shape"])
                nq = int(artifacts["n_codebooks"])
                vbr_counts = decode_adaptive(
                    artifacts["counts_rc"].tobytes(), int(np.prod(shape)), nq + 1,
                ).astype(np.uint8).reshape(shape)
                kept = decode_adaptive(
                    artifacts["codes_rc"].tobytes(), n_codes, n_sym,
                    _kept_stage_contexts(vbr_counts, nq), nq)
                codes = unpack_vbr_codes(kept, vbr_counts, nq)
            else:
                shape = tuple(artifacts["codes_shape"])
                codes = decode_adaptive(
                    artifacts["codes_rc"].tobytes(), n_codes, n_sym,
                    _stage_contexts(shape), int(shape[1]),
                ).astype(np.int32).reshape(shape)
        elif "counts_bits" in artifacts:
            # bit-packed VBR
            shape = tuple(artifacts["counts_shape"])
            vbr_counts = unpack_bits(
                artifacts["counts_bits"], artifacts["count_bits"],
                int(np.prod(shape)),
            ).astype(np.uint8).reshape(shape)
            kept = unpack_bits(
                artifacts["codes_bits"], artifacts["code_bits"],
                artifacts["n_codes"],
            )
            codes = unpack_vbr_codes(kept, vbr_counts, artifacts["n_codebooks"])
        elif "codes_bits" in artifacts:
            # bit-packed CBR (compact=True)
            shape = tuple(artifacts["codes_shape"])
            codes = unpack_bits(
                artifacts["codes_bits"], artifacts["code_bits"],
                artifacts["n_codes"],
            ).astype(np.int32).reshape(shape)
        elif "codes_packed" in artifacts:
            # earlier VBR format (unpacked-bits kept codes)
            codes = unpack_vbr_codes(
                artifacts["codes_packed"], vbr_counts, artifacts["n_codebooks"]
            )
        else:
            # reference-compatible plain uint16
            codes = artifacts["codes"].astype(np.int32)
        return cls(codes=codes, vbr_counts=vbr_counts, **metadata)
