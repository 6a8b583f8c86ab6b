"""Chunked compression API: wav -> ``.dac`` -> wav.

Counterpart of ``vrvq_tpu/infer/codec_api.py`` (``CodecProcessor``):

  * a signal no longer than the window is coded in one shot by the padded
    codec;
  * a longer one by the padding-free codec on fixed windows, zero-padded by
    the receptive delay at both ends, with a stride of one window's
    padding-free decode length so that decoded windows join seamlessly
    (``window_geometry``);
  * loudness is measured (BS.1770), normalized to ``normalize_db`` before
    encoding and restored after decoding.

VBR: with ``level`` the per-frame codebook counts go into the ``.dac``
(``vbr_counts``) and ``decompress`` rebuilds the stage mask from them. A CBR
model (``model_type='CBR'``) codes at ``n_quantizers`` (all Nq by default).

A ``DAC_MOE``'s VBR mask is not a prefix of the stages, which counts cannot
hold: its VBR ``compress`` raises (CBR serves as any CBR request does), and
its VBR serving path is ``model.encode`` at a level with
``decode_from_codes(codes, mask)``.

``fused_quantizer=True`` encodes through the fused RVQ kernel
(``ops/rvq_kernel.py``): encoder, importance subnet and counts (VBR only),
then all Nq stages in one launch, of which a CBR request keeps the first
``n_quantizers``. Its weights are stacked and prepared once per
``compress`` call (once per stream object in ``infer/streaming.py``), from
the model's parameters as they are then. As in the JAX version it takes a
``DAC_VRVQ`` only, and one codebook width for every stage.

PyTorch runs eagerly, so the JAX version's jitted programs are plain calls
here. As in the JAX version, the windowed paths dispatch every window before
they fetch any result: the signal goes to the device in one copy
(``put_batch``), each window's work is queued on the card, and the results
come back in one copy at the end, so the host never waits for the card
between windows. Everything runs under ``torch.inference_mode()``, with TF32
off.

Over several cards (``devices``, the JAX version's ``mesh``) the processor
keeps a replica of the model on each and, with the fused quantizer, each
replica's prepared weights. The replicas are copies of the parameters as
they were when the processor was made, the first card's too, so every block
of a batch is coded by the same weights: a processor over several cards does
not follow later changes to ``model`` (make a new one). On one card it uses
``model`` itself. ``put_batch`` splits a batch whose rows divide the card
count into equal row blocks, one a card (``Rows``); each block runs on its
card's replica, one after another from this thread, and the results are
gathered on the first card in row order. A batch that does not divide runs
whole on the first card (the JAX version's replicated fallback): the same
codes either way.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Union

import numpy as np
import torch

from .. import disable_tf32
from ..audio import Signal
from ..models import codec as codec_arith
from ..models.codec import DACFile
from ..models.dac_moe import DAC_MOE
from ..ops.masks import generate_mask_hard
from ..ops.rvq_kernel import (check_uniform_widths, prepare_rvq,
                               quantize_fused, stack_quantizer_weights)


def check_counts_hold_mask(model, vbr: bool) -> None:
    """Raise for a VBR request of a model whose mask counts cannot hold."""
    if vbr and not model.prefix_mask:
        raise NotImplementedError(
            f"{type(model).__name__}'s VBR mask thresholds each stage's "
            "router score on its own, so it need not keep a prefix of the "
            "stages, and the .dac's vbr_counts (stages kept a frame) cannot "
            "hold it. Serve it with model.encode(audio, level=...) and "
            "model.decode_from_codes(codes, mask), or at n_quantizers (CBR)")


class Rows:
    """A batch on the processor's cards: its row blocks in row order, block
    i on card i (one block, on the first card, where the batch does not
    divide the card count)."""

    def __init__(self, blocks: Sequence[torch.Tensor]):
        self.blocks = list(blocks)

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Rows":
        """``fn`` applied to every block."""
        return Rows([fn(b) for b in self.blocks])

    def __getitem__(self, index) -> "Rows":
        """An index of the axes after the rows, applied to every block."""
        return self.map(lambda b: b[(slice(None), *index)]
                        if isinstance(index, tuple) else b[:, index])


class CodecProcessor:
    """Host-side orchestrator of the padded and padding-free codecs, which
    share ``model``'s parameters and device; over ``devices`` (several
    cards) with a replica on each."""

    def __init__(self, model, fused_quantizer: bool = False,
                 devices: Optional[Sequence] = None):
        if fused_quantizer:
            if isinstance(model, DAC_MOE):
                raise ValueError(
                    "fused_quantizer supports DAC_VRVQ only (the DAC_MOE "
                    "router quantizer has a different importance path)")
            check_uniform_widths(model.quantizer)
        disable_tf32()
        self.model = model.eval()
        self.model_nopad = model.clone(padding=False).eval()
        here = next(model.parameters()).device
        self.devices = ([here] if devices is None
                        else [torch.device(d) for d in devices])
        if not self.devices:
            raise ValueError("devices: at least one")
        self.device = self.devices[0]
        self.fused_quantizer = fused_quantizer
        # (padded, padding-free) codec on each card, sharing that card's
        # parameters: `model` itself on its own card alone, else copies
        if self.devices == [here]:
            self.replicas = [(self.model, self.model_nopad)]
        else:
            self.replicas = [self._replica(d) for d in self.devices]

    def _replica(self, device: torch.device):
        with torch.no_grad():
            model = self.model.with_state(
                {k: v.to(device, copy=True)
                 for k, v in self.model.state_dict().items()}).eval()
        return model, model.clone(padding=False).eval()

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    # ------------------------------------------------------------ encode
    def _encode(self, variant, audio: torch.Tensor,
                n_quantizers: Optional[int], level: float, rvq=None):
        """(codes (B, Nq', T'), counts (B, T') uint8 or None) on the device;
        counts only in VBR (a VBR model, ``n_quantizers`` None). ``rvq``: the
        prepared quantizer weights, with ``fused_quantizer``."""
        n_q = variant.n_codebooks
        vbr = variant.vbr and n_quantizers is None
        if not self.fused_quantizer:
            enc = variant.encode(audio, n_quantizers=n_quantizers, level=level)
            counts = None
            if vbr:
                counts = self._counts(enc["imp_map"], level, n_q)
            return enc["codes"], counts
        # fused: the module path's encoder and importance subnet, then the
        # whole residual loop in one kernel launch
        z, feat = variant.encoder(audio, return_feat=True)
        counts = None
        if vbr:
            imp_map = variant.quantizer.importance(feat, z.shape[-1])
            counts = self._counts(imp_map, level, n_q)
        _, codes = quantize_fused(rvq, z)
        if n_quantizers is not None:
            codes = codes[:, :n_quantizers]  # CBR: later stages are unused
        return codes, counts

    @staticmethod
    def _counts(imp_map: torch.Tensor, level: float, n_q: int) -> torch.Tensor:
        return torch.sum(
            generate_mask_hard(imp_map * level * n_q, n_q), dim=1
        ).to(torch.uint8)

    def prepared_rvq(self) -> Optional[List]:
        """Each replica's quantizer weights prepared for the fused kernel,
        from the parameters as they are now (one a card); ``None`` without
        ``fused_quantizer``."""
        if not self.fused_quantizer:
            return None
        return [prepare_rvq(stack_quantizer_weights(m.quantizer))
                for m, _ in self.replicas]

    def put_batches(self, x: np.ndarray, sizes: Sequence[int]) -> List[Rows]:
        """The batches stacked in host array ``x`` (``sizes`` rows each) on
        the cards, in one copy a card: where every size divides the card
        count, card i gets the i-th row block of every batch; else each
        batch lies whole on the first card."""
        x = np.ascontiguousarray(x)
        n = self.n_devices
        starts = np.cumsum([0, *sizes])
        if n == 1 or any(size % n for size in sizes):
            whole = torch.from_numpy(x).to(self.device)
            return [Rows([whole[a:b]]) for a, b in zip(starts[:-1], starts[1:])]
        # card i's rows: the i-th block of each batch, side by side
        order = [np.arange(a + i * (size // n), a + (i + 1) * (size // n))
                 for i in range(n) for a, size in zip(starts[:-1], sizes)]
        parts = np.split(x[np.concatenate(order)], n)
        on_cards = [torch.from_numpy(part).to(d) for part, d in zip(parts, self.devices)]
        return [Rows([t[a // n:b // n] for t in on_cards])
                for a, b in zip(starts[:-1], starts[1:])]

    def put_batch(self, x: np.ndarray) -> Rows:
        """A host batch on the cards (``put_batches`` of one batch)."""
        return self.put_batches(x, [len(x)])[0]

    def gather(self, blocks: Sequence[Optional[torch.Tensor]]) -> Optional[torch.Tensor]:
        """Per-card results in row order, on the first card."""
        if blocks[0] is None:
            return None
        if len(blocks) == 1:
            return blocks[0]
        return torch.cat([b.to(self.device) for b in blocks])

    def encode_rows(self, padding: bool, rows: Rows, n_quantizers: Optional[int],
                    level: float, rvq: Optional[List] = None):
        """``_encode`` of each block on its card's replica (padded or
        padding-free; ``rvq`` from ``prepared_rvq``), gathered: (codes,
        counts) on the first card."""
        out = [self._encode(self.replicas[i][0 if padding else 1], block,
                            n_quantizers, level, None if rvq is None else rvq[i])
               for i, block in enumerate(rows.blocks)]
        return self.gather([c for c, _ in out]), self.gather([n for _, n in out])

    def decode_rows(self, padding: bool, codes: Rows, mask: Rows) -> torch.Tensor:
        """``decode_from_codes`` of each block on its card's replica,
        gathered on the first card."""
        return self.gather([self.replicas[i][0 if padding else 1].decode_from_codes(c, m)
                            for i, (c, m) in enumerate(zip(codes.blocks, mask.blocks))])

    # ---------------------------------------------------------- geometry
    def window_geometry(self, win_duration: float):
        """``(window, hop, frames, delay)`` of the padding-free windowed
        path: window length in samples (a hop multiple), the stride between
        windows, codes frames per window and the zero-pad delay at the ends.

        The walk covers only the encoder and decoder convs, the chain the
        decoded audio passes through; the importance subnet is a side branch
        that does not shorten it. So the padding-free decode of one window's
        frames is exactly ``hop`` samples long."""
        model = self.model
        n_samples = int(win_duration * model.sample_rate)
        window = int(
            math.ceil(n_samples / model.hop_length) * model.hop_length
        )
        chain = (
            codec_arith.encoder_conv_specs(model.config.encoder_rates)
            + codec_arith.decoder_conv_specs(model.config.decoder_rates)
        )
        hop = codec_arith.output_length(chain, window)
        edge_delay = codec_arith.delay(chain)
        if hop <= 0:
            min_win = (2 * edge_delay + model.hop_length) / model.sample_rate
            raise ValueError(
                f"win_duration={win_duration}s is smaller than the "
                f"model's receptive field; the padding-free window "
                f"produces no output. Use win_duration > {min_win:.2f}s."
            )
        frames = codec_arith.output_length(
            codec_arith.encoder_conv_specs(model.config.encoder_rates), window
        )
        return window, hop, frames, edge_delay

    # ------------------------------------------------------------ compress
    def compress(
        self,
        audio_path_or_signal: Union[str, Path, Signal],
        win_duration: Optional[float] = 1.0,
        normalize_db: Optional[float] = -16,
        n_quantizers: Optional[int] = None,
        level: Optional[float] = None,
    ) -> DACFile:
        """Audio -> ``DACFile``. VBR when ``level`` is given and
        ``n_quantizers`` is not; ``win_duration=None`` codes in one shot."""
        with torch.inference_mode():
            return self._compress(audio_path_or_signal, win_duration,
                                  normalize_db, n_quantizers, level)

    def _compress(self, audio_path_or_signal, win_duration, normalize_db,
                  n_quantizers, level) -> DACFile:
        model = self.model
        signal = audio_path_or_signal
        if isinstance(signal, (str, Path)):
            signal = Signal.load(signal)
        signal = signal.clone()
        original_sr = signal.sample_rate
        original_length = signal.signal_length

        signal.resample(model.sample_rate)
        input_db = float(signal.loudness()[0])
        if normalize_db is not None:
            signal.normalize(normalize_db)
        signal.ensure_max_of_audio()

        data = np.asarray(signal.audio_data, np.float32)
        nb, nac, nt = data.shape
        data = data.reshape(nb * nac, 1, nt)
        if win_duration is None:
            win_duration = signal.signal_duration

        vbr = n_quantizers is None and level is not None
        if vbr and not model.vbr:
            raise ValueError("a CBR model codes at n_quantizers; level is "
                             "for a VBR model")
        check_counts_hold_mask(model, vbr)
        lv = level if level is not None else 1.0
        rvq = self.prepared_rvq()

        if signal.signal_duration <= win_duration:
            # one shot through the padded codec
            padding = True
            right_pad = math.ceil(nt / model.hop_length) * model.hop_length - nt
            x = np.pad(data, ((0, 0), (0, 0), (0, right_pad)))
            codes, counts = self.encode_rows(True, self.put_batch(x),
                                             n_quantizers, lv, rvq)
            codes_list, counts_list = [codes], [counts]
        else:
            # padding-free codec on windows, the ends padded by the delay and
            # the last window by zeros: the whole signal in one copy, every
            # window queued on the device before any result is fetched
            padding = False
            n_samples, hop, _, delay = self.window_geometry(win_duration)
            starts = range(0, nt, hop)
            tail = starts[-1] + n_samples - (nt + 2 * delay)
            data = self.put_batch(np.pad(
                data, ((0, 0), (0, 0), (delay, delay + max(tail, 0)))))
            codes_list, counts_list = [], []
            for i in starts:
                codes_i, counts_i = self.encode_rows(
                    False, data[..., i: i + n_samples], n_quantizers, lv, rvq)
                codes_list.append(codes_i)
                counts_list.append(counts_i)
        chunk_length = codes_list[0].shape[-1]
        codes = torch.cat(codes_list, dim=-1).cpu().numpy()
        counts = torch.cat(counts_list, dim=-1).cpu().numpy() if vbr else None

        return DACFile(
            codes=np.ascontiguousarray(codes, np.int32),
            chunk_length=chunk_length,
            original_length=original_length,
            input_db=input_db,
            channels=nac,
            sample_rate=original_sr,
            padding=padding,
            vbr_counts=counts,
        )

    # ---------------------------------------------------------- decompress
    def decompress(self, obj: Union[str, Path, DACFile]) -> Signal:
        """``DACFile`` (or its path) -> Signal at the file's length and
        loudness."""
        with torch.inference_mode():
            return self._decompress(obj)

    def _decompress(self, obj) -> Signal:
        model = self.model
        if isinstance(obj, (str, Path)):
            obj = DACFile.load(obj)

        codes = np.asarray(obj.codes, np.int32)
        chunk_length = obj.chunk_length

        # the codes and the stage mask of every chunk, the last one padded to
        # a whole chunk, in one copy each; every chunk queued on the device
        # before the audio is fetched
        _, n_q, frames = codes.shape
        pad = -frames % chunk_length
        codes = np.pad(codes, ((0, 0), (0, 0), (0, pad)))
        if obj.vbr_counts is not None:
            counts = np.pad(np.asarray(obj.vbr_counts), ((0, 0), (0, pad)))
            stage = np.arange(n_q).reshape(1, n_q, 1)
            mask = (stage < counts[:, None, :]).astype(np.float32)
        else:
            mask = np.ones(codes.shape, np.float32)
        codes = self.put_batch(codes).map(torch.Tensor.long)
        mask = self.put_batch(mask)
        parts = [
            self.decode_rows(obj.padding, codes[..., i: i + chunk_length],
                             mask[..., i: i + chunk_length])
            for i in range(0, frames, chunk_length)
        ]
        audio = torch.cat(parts, dim=-1).cpu().numpy()
        out = Signal(audio, model.sample_rate)
        out.normalize(obj.input_db)
        out.resample(obj.sample_rate)
        out.audio_data = out.audio_data[..., : obj.original_length]
        out.audio_data = out.audio_data.reshape(
            -1, obj.channels, obj.original_length
        )
        return out
