"""``work.py``'s counts, taken from the architecture, equal a count taken
by hooks on the plain reference's layers as it runs (on the meta device,
at the cells' full sizes): every conv's multiply-adds and every Snake's
elements, for vrvq_a2 and vrvq_a2_24k."""

import json
import math

import pytest
import torch
import torch.nn.functional as F

from codec_bench import harness, work
from codec_bench.reference import codec as ref_codec
from codec_bench.reference.train import Discriminator, WNConv2d


def keys_of(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json").read_text())["keys"]


class Count:
    def __init__(self, module):
        self.macs, self.snakes, self.handles = 0, [], []
        for m in module.modules():
            if isinstance(m, (ref_codec.WNConv, WNConv2d)):
                self.handles.append(m.register_forward_hook(self.conv))
            elif isinstance(m, ref_codec.Snake):
                self.handles.append(m.register_forward_hook(self.snake))

    def conv(self, m, inputs, out):
        x = inputs[0]
        if isinstance(m, WNConv2d):
            _, cin, kh, kw = m.weight_v.shape
            self.macs += out.numel() * cin * kh * kw
        elif m.transposed:
            cin, cout, k = m.weight_v.shape
            self.macs += x.numel() * cout * k
        else:
            _, cin, k = m.weight_v.shape
            self.macs += out.numel() * cin * k

    def snake(self, m, inputs, out):
        self.snakes.append(tuple(inputs[0].shape))


def meta_codec(keys):
    with torch.device("meta"):
        return ref_codec.Codec(keys)


@pytest.mark.parametrize("name", ["vrvq_a2", "vrvq_a2_24k"])
def test_oneshot_counts(name):
    keys = keys_of(name)
    model = meta_codec(keys)
    rows, samples = 2, 441344
    enc_count = Count(model.encoder)
    imp_count = Count(model.quantizer.imp_subnet)
    dec_count = Count(model.decoder)
    x = torch.empty(rows, 1, samples, device="meta")
    z, feat = model.encoder(x)
    model.importance(feat, z.shape[-1])
    model.decoder(z)
    enc, frames, featf = work.encoder(keys, samples)
    assert frames == z.shape[-1] and featf == feat.shape[-1]
    assert rows * enc.macs == enc_count.macs
    assert rows * work.importance(keys, featf).macs == imp_count.macs
    dec, out = work.decoder(keys, frames)
    assert rows * dec.macs == dec_count.macs
    expect = work.oneshot(keys, rows, samples)
    nq, d, code, size = (keys[f"DAC_VRVQ.{k}"] for k in
                         ("n_codebooks", "encoder_dim", "codebook_dim", "codebook_size"))
    latent = d * 2 ** len(keys["DAC_VRVQ.encoder_rates"])
    rvq = rows * nq * frames * (3 * latent * code + size * code)
    assert expect["flops_f32"] == 2 * (enc_count.macs + imp_count.macs + rvq)
    assert expect["flops_bf16"] == 2 * dec_count.macs
    snakes = [(enc_count.snakes, 4), (imp_count.snakes, 4), (dec_count.snakes, 2)]
    got = sum(size * 2.0 * math.prod(s) + 4.0 * s[1] for group, size in snakes for s in group)
    assert expect["snake_bytes"] == pytest.approx(got, rel=1e-12)


def test_padding_free_counts():
    keys = keys_of("vrvq_a2")
    with torch.device("meta"):
        model = ref_codec.Codec(keys, padding=False)
    count = Count(model.encoder)
    z, _ = model.encoder(torch.empty(3, 1, 44544, device="meta"))
    enc, frames, _ = work.encoder(keys, 44544, padding=False)
    assert frames == z.shape[-1] and 3 * enc.macs == count.macs


def test_train_step_counts():
    keys = keys_of("vrvq_a2")
    rows, samples = 2, 16758
    gen = meta_codec(keys)
    with torch.device("meta"):
        disc = Discriminator(keys)
    g_count, d_count = Count(gen), Count(disc)
    x = torch.empty(rows, 1, samples, device="meta")
    z, feat = gen.encoder(F.pad(x, (0, -samples % gen.hop)))
    gen.importance(feat, z.shape[-1])
    gen.decoder(z)
    nq, code, size = (keys[f"DAC_VRVQ.{k}"] for k in ("n_codebooks", "codebook_dim", "codebook_size"))
    rvq = rows * nq * z.shape[-1] * (2 * 1024 * code + size * code)
    assert work.generator_forward(keys, rows, samples) == 2 * (g_count.macs + rvq)
    try:
        disc(torch.empty(rows, 1, samples, device="meta"))
    except (NotImplementedError, RuntimeError) as exc:  # no meta STFT here
        pytest.skip(f"the discriminator does not run on meta tensors: {exc}")
    assert work.discriminator_forward(keys, rows, samples) == 2 * d_count.macs
