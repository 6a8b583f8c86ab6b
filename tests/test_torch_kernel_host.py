"""The host side of the port's two kernels, on the CPU.

* The launch census that PERF.md's Snake table rests on: one padding-free
  window of the flagship's topology (``small_config``) calls ``Snake1d`` 35
  times in encode (29 in the encoder, 6 in the importance subnet) and 29 times
  in decode.
* The cluster size the fused-RVQ wrapper picks, and the weights that
  ``prepare_rvq`` packs by (stage, CTA) for the kernel: a plain emulation of
  the kernel's cluster algorithm (partials summed in rank order, candidates
  reduced in rank order with the lowest index on ties, the code's row taken
  from its owner's slice) on the packed blocks gives the JAX ``fused_rvq``'s
  codes (interpret mode) off near ties (top-2 margin > 1e-5) and its z_q
  within 1e-5 on the frames that agree, at the flagship's shapes and at
  shapes the packing pads (d not a power of two, D and K not split into
  slices of a multiple of 4); duplicated codebook rows in two CTAs' slices
  resolve to the lower index, as argmax does.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vrvq_tpu.ops import rvq_kernel as jrvq
import vrvq_tpu_torch as port
from vrvq_tpu_torch.kernel_times import snake_census
from vrvq_tpu_torch.ops import rvq_kernel as trvq

torch.set_num_threads(1)  # as tests/test_torch_support.py sets it

ZQ_TOL = 1e-5
TIE_MARGIN = 1e-5


@pytest.fixture(scope="module")
def window_census():
    """Snake1d calls by part of the model for a 2.5 s clip, in 1 s padding-free
    windows or more: compress, then decompress."""
    model = port.build_model(port.small_config(), device="cpu", seed=0)
    proc = port.CodecProcessor(model, fused_quantizer=True)
    sig = port.Signal(port.synthetic_clip(2.5, 44100, 0), 44100)
    nopad = proc.model_nopad
    with snake_census(nopad.encoder) as enc, \
            snake_census(nopad.quantizer) as imp, \
            snake_census(nopad) as encode:
        dac = proc.compress(sig, win_duration=1.0, level=1.0)
    with snake_census(nopad.decoder) as dec, snake_census(nopad) as decode:
        proc.decompress(dac)
    windows = dac.codes.shape[-1] // dac.chunk_length
    return windows, {"encoder": enc, "importance": imp, "encode": encode,
                     "decoder": dec, "decode": decode}


@pytest.mark.parametrize("part,per_window", [
    ("encoder", 29), ("importance", 6), ("encode", 35), ("decoder", 29),
    ("decode", 29)])
def test_snake_census_of_one_window(window_census, part, per_window):
    windows, census = window_census
    assert windows > 1
    assert sum(census[part].values()) == per_window * windows
    # every window hands the kernel the same shapes
    assert all(n % windows == 0 for n in census[part].values())


@pytest.mark.parametrize("d_model,k,expected", [
    (1024, 1024, 8), (256, 128, 8), (256, 64, 8), (96, 64, 8), (48, 64, 4),
    (40, 64, 2), (100, 64, 1), (6, 64, 1), (1000, 1000, 8), (1000, 1024, 8),
    (1024, 6, 8), (6, 6, 1), (200, 300, 4)])
def test_cluster_size(d_model, k, expected):
    assert trvq.cluster_size(d_model, k) == expected


def _weights(rng, nq, dim, k, d):
    return trvq.RVQWeights(
        torch.from_numpy((rng.uniform(-1, 1, (nq, dim, d))
                          / np.sqrt(dim)).astype(np.float32)),
        torch.from_numpy(0.1 * rng.randn(nq, d).astype(np.float32)),
        torch.from_numpy((rng.uniform(-1, 1, (nq, d, dim))
                          / np.sqrt(d)).astype(np.float32)),
        torch.from_numpy(0.1 * rng.randn(nq, dim).astype(np.float32)),
        torch.from_numpy(rng.randn(nq, k, d).astype(np.float32)),
    )


def emulate_cluster(z, prepared, mask=None):
    """The kernel's algorithm on the packed blocks, one CTA slice at a time,
    in plain PyTorch, at the padded widths. Returns (z_q, codes)."""
    w, cs, packed = prepared
    n_q, d_model, _ = w.wi.shape
    dp_model, kp, d = trvq.padded_dims(d_model, w.cb.shape[1], w.wi.shape[2], cs)
    dc, kc = dp_model // cs, kp // cs
    f = z.shape[0]
    zp = torch.nn.functional.pad(z, (0, dp_model - d_model))
    res = [zp[:, r * dc:(r + 1) * dc].clone() for r in range(cs)]
    acc = [torch.zeros_like(x) for x in res]
    codes = torch.zeros(f, n_q, dtype=torch.int32)
    for s in range(n_q):
        blocks = []
        for r in range(cs):
            sizes = [d * dc, d * dc, dc, d * kc, kc, kc * d, d]
            assert packed.shape[2] == -(-sum(sizes) // 4) * 4
            wi_t, wo, bo, cn_t, cn2, cb, bi = torch.split(
                packed[s, r, :sum(sizes)], sizes)
            blocks.append((wi_t.reshape(d, dc), wo.reshape(d, dc), bo,
                           cn_t.reshape(d, kc), cn2, cb.reshape(kc, d), bi))
        e = res[0] @ blocks[0][0].T
        for r in range(1, cs):
            e = e + res[r] @ blocks[r][0].T
        e = e + blocks[0][6]
        en = e / torch.clamp(torch.sqrt(torch.sum(e * e, dim=1, keepdim=True)),
                             min=1e-12)
        n2 = torch.sum(en * en, dim=1, keepdim=True)
        best = torch.full((f,), float("inf"))
        code = torch.zeros(f, dtype=torch.long)
        for r in range(cs):
            dist = (n2 - 2.0 * (en @ blocks[r][3])) + blocks[r][4]
            local_best, local_arg = torch.min(dist, dim=1)  # first minimum
            better = local_best < best  # an earlier rank keeps a tie
            best = torch.where(better, local_best, best)
            code = torch.where(better, local_arg + r * kc, code)
        codes[:, s] = code.to(torch.int32)
        owner, row = code // kc, code % kc
        q = torch.stack([blocks[o][5][i] for o, i in zip(owner.tolist(),
                                                         row.tolist())])
        zq_e = e + (q - e)
        m = mask[:, s:s + 1] if mask is not None else 1.0
        for r in range(cs):
            out = zq_e @ blocks[r][1] + blocks[r][2]
            res[r] = res[r] - out
            acc[r] = acc[r] + out * m
    return torch.cat(acc, dim=1)[:, :d_model], codes


@pytest.mark.parametrize("dim,nq,k,d,vbr,cs", [
    (256, 4, 128, 8, True, 8), (256, 4, 64, 4, False, 8),
    (1024, 3, 1024, 8, True, 8), (1000, 2, 1000, 16, True, 8),
    (200, 2, 300, 3, True, 4), (6, 3, 6, 1, False, 1),
    (64, 2, 40, 2, True, 2), (128, 2, 96, 32, False, 8)],
    ids=["D256-K128-d8-VBR", "D256-K64-d4-CBR", "D1024-K1024-d8-VBR",
         "D1000-K1000-d16-VBR", "D200-K300-d3-VBR", "D6-K6-d1-CBR",
         "D64-K40-d2-VBR", "D128-K96-d32-CBR"])
def test_packed_cluster_emulation_matches_jax(dim, nq, k, d, vbr, cs):
    rng = np.random.RandomState(dim + k)
    w = _weights(rng, nq, dim, k, d)
    z = rng.randn(45, dim).astype(np.float32)  # 45: no multiple of a tile
    mask = (rng.rand(45, nq) > 0.4).astype(np.float32) if vbr else None
    prepared = trvq.prepare_rvq(w)
    assert prepared.cluster == cs
    tmask = torch.from_numpy(mask) if vbr else None
    zq, codes = emulate_cluster(torch.from_numpy(z), prepared, tmask)
    k_zq, k_codes = jrvq.fused_rvq(
        jnp.asarray(z), *(jnp.asarray(t.numpy()) for t in w),
        jnp.asarray(mask) if vbr else None, interpret=True)
    near_tie = (trvq.reference_margins(torch.from_numpy(z), *w)
                <= TIE_MARGIN).numpy()
    agree = (codes.numpy() == np.asarray(k_codes)).all(axis=1)
    assert not (~agree & ~near_tie).any()
    np.testing.assert_allclose(zq.numpy()[agree], np.asarray(k_zq)[agree],
                               rtol=ZQ_TOL, atol=ZQ_TOL)


def test_duplicated_rows_in_two_slices_take_the_lower_index():
    """Rows 2 Kc + 3 and 5 Kc + 1 are equal and e points at them: the exact
    tie goes to the lower index in the emulation and the plain version."""
    rng = np.random.RandomState(3)
    nq, dim, k, d = 2, 256, 128, 8
    w = _weights(rng, nq, dim, k, d)
    kc = k // trvq.cluster_size(dim, k)
    lo, hi = 2 * kc + 3, 5 * kc + 1
    w.cb[:, hi] = w.cb[:, lo]
    w.wi.mul_(1e-3)
    w.bi.copy_(10.0 * w.cb[:, lo])
    z = torch.from_numpy(rng.randn(20, dim).astype(np.float32))
    _, codes = emulate_cluster(z, trvq.prepare_rvq(w))
    _, ref_codes = trvq.fused_rvq_reference(z, *w)
    assert (codes == lo).all() and (ref_codes == lo).all()
