"""``vrvq_tpu_torch.parallel`` and serving over several devices, against the
JAX package's mesh helpers, on the CPU.

``data_world_size`` is the JAX trainer's ``_data_mesh_size`` at the cases of
``tests/test_trainer_integration.py::test_data_mesh_size_selection``;
``local_rows`` partitions each global batch as the JAX loader's
``local_slice`` does (one micro-batch), and each micro-batch into the ranks'
blocks (two); the pools' ``_padded_batch(b, n)`` is JAX's for b 1-16 and
n 1-8; ``CodecProcessor(devices=["cpu", "cpu"])`` gives the single-device
codes and counts bit for bit on a batch that splits (4) and one that does
not (3), through ``put_batch``, the pools and ``compress``, and the same
audio within 1e-5 (a block decodes at another batch size than the whole,
which may round a conv's sums otherwise); and ``init_distributed`` puts
JAX's multi-host flags and torchrun's environment on the same ranks.
"""

import types

import numpy as np
import pytest
import torch

from vrvq_tpu.infer import streaming as jstreaming
from vrvq_tpu.train.trainer import _batch_iterator, _data_mesh_size
import vrvq_tpu_torch as port
from vrvq_tpu_torch.cli import train as train_cli
from vrvq_tpu_torch.infer import streaming
from vrvq_tpu_torch.parallel import dist as pdist
from vrvq_tpu_torch.train import trainer
from tests import test_torch_dist_support as support

torch.set_num_threads(1)

WINDOW_S = 0.6


@pytest.mark.parametrize("batch,cards,procs", [
    (16, 8, 1), (12, 8, 1), (7, 8, 1), (5, 4, 1), (8, 4, 2), (6, 4, 2), (2, 4, 2)])
def test_data_world_size_matches_jax(batch, cards, procs):
    try:
        want = _data_mesh_size(batch, cards, procs)
    except ValueError as e:
        with pytest.raises(ValueError, match="divisible by the global device"):
            pdist.data_world_size(batch, cards, procs)
        assert "divisible by the global device" in str(e)
        return
    assert pdist.data_world_size(batch, cards, procs) == want


@pytest.mark.parametrize("batch,accum,cards,want", [
    (32, 8, 8, 4), (32, 1, 8, 8), (64, 4, 8, 8), (12, 2, 8, 6), (12, 1, 8, 6),
    (16, 4, 3, 2)])
def test_cli_spawn_world_divides_every_micro_batch(batch, accum, cards, want):
    """The train CLI's start without flags takes the most cards that divide
    each micro-batch, so every rank's ``local_rows`` exist; with one
    micro-batch that is JAX's ``_data_mesh_size``."""
    n = train_cli.spawn_world(batch, accum, cards)
    assert n == want
    rows = sorted(row for r in range(n) for row in pdist.local_rows(batch, r, n, accum))
    assert rows == list(range(batch))
    if accum == 1:
        assert n == _data_mesh_size(batch, cards, 1)


def test_cli_spawn_world_names_an_accumulation_that_does_not_divide():
    with pytest.raises(ValueError, match="batch_size 32 is not divisible by "
                                         "grad_accum_steps=3"):
        train_cli.spawn_world(32, 3, 8)


class DS:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"x": i}

    @staticmethod
    def collate(items):
        return {"xs": [it["x"] for it in items]}


@pytest.mark.parametrize("accum", [1, 2])
def test_local_rows_partition_the_global_batch(accum):
    """A world of 2, global batch 8, steps 0-2 (the 10-item set wraps): with
    one micro-batch each rank loads the JAX ``local_slice`` block; with two,
    rank r loads rows 2r, 2r + 1 of each micro-batch of 4, so micro-batch k
    of the ranks in rank order is rows 4k..4k+3 of the global batch."""
    batch, world = 8, 2
    rows = [pdist.local_rows(batch, r, world, accum) for r in range(world)]
    assert sorted(rows[0] + rows[1]) == list(range(batch))
    full = _batch_iterator(DS(), batch_size=batch)
    slices = [_batch_iterator(DS(), batch_size=batch, local_slice=(r * 4, r * 4 + 4))
              for r in range(world)]
    for step in range(3):
        want = next(full)["xs"]
        got = [trainer.load_batch(DS(), step, batch, rows[r])["xs"] for r in range(world)]
        if accum == 1:
            assert got == [next(s)["xs"] for s in slices]
        micro = [sum((g[k * 2:(k + 1) * 2] for g in got), [])
                 for k in range(accum)] if accum > 1 else [got[0] + got[1]]
        assert sum(micro, []) == want
    with pytest.raises(ValueError, match="batch size 3 not divisible by 2 ranks"):
        pdist.local_rows(6, 0, 2, 2)
    with pytest.raises(ValueError, match="grad_accum_steps=4"):
        pdist.local_rows(6, 0, 2, 4)


def test_padded_batch_matches_jax():
    for n in range(1, 9):
        mesh = types.SimpleNamespace(devices=np.empty(n)) if n > 1 else None
        for b in range(1, 17):
            assert streaming._padded_batch(b, n) == jstreaming._padded_batch(b, mesh), (b, n)


@pytest.fixture(scope="module")
def processors():
    model = port.build_model(port.small_config(), device="cpu", seed=3)
    return (port.CodecProcessor(model),
            port.CodecProcessor(model, devices=["cpu", "cpu"]))


@pytest.mark.parametrize("batch", [4, 3])
def test_codec_processor_over_two_devices_gives_one_devices_codes(processors, batch):
    one, two = processors
    window = one.window_geometry(WINDOW_S)[0]
    x = np.concatenate([port.synthetic_clip(1.0, 44100, 40 + i)[..., :window]
                        for i in range(batch)])
    rows = two.put_batch(x)
    assert len(rows.blocks) == (2 if batch % 2 == 0 else 1)
    assert [len(b) for b in rows.blocks] == ([2, 2] if batch == 4 else [3])
    with torch.inference_mode():
        want = one.encode_rows(False, one.put_batch(x), None, 1.0)
        got = two.encode_rows(False, rows, None, 1.0)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        mask = (torch.arange(4)[None, :, None] < want[1][:, None, :]).float().numpy()
        codes = want[0].numpy()
        audio = one.decode_rows(False, one.put_batch(codes).map(torch.Tensor.long),
                                one.put_batch(mask))
        audio2 = two.decode_rows(False, two.put_batch(codes).map(torch.Tensor.long),
                                 two.put_batch(mask))
    torch.testing.assert_close(audio2, audio, rtol=0, atol=1e-5)


@pytest.mark.parametrize("streams", [4, 3])
def test_pools_over_two_devices_give_one_devices_codes(processors, streams):
    """3 streams pad each pool batch to 4, which splits over the 2 devices."""
    clips = {f"s{i}": port.synthetic_clip(1.5, 44100, 60 + i)[0, 0] for i in range(streams)}

    def encode(proc):
        pool = streaming.StreamPool(proc, win_duration=WINDOW_S, level=1.0, max_batch=4)
        out = []
        for sid, x in clips.items():
            pool.add_stream(sid)
            pool.push(sid, x)
        out += pool.poll()
        for sid in clips:
            pool.flush(sid)
        return out + pool.poll()

    def decode(proc, chunks):
        dp = streaming.DecoderPool(proc, win_duration=WINDOW_S, max_batch=4)
        for sid, c, n in chunks:
            dp.push(sid, c, n)
        return dp.poll()

    one, two = processors
    want, got = encode(one), encode(two)
    assert [s for s, _, _ in got] == [s for s, _, _ in want]
    for (_, c1, n1), (_, c2, n2) in zip(want, got):
        assert np.array_equal(c1, c2) and np.array_equal(n1, n2)
    for (_, a1), (_, a2) in zip(decode(one, want), decode(two, want)):
        np.testing.assert_allclose(a2, a1, rtol=0, atol=1e-5)


def test_compress_over_two_devices(processors):
    one, two = processors
    signal = port.Signal(np.concatenate([port.synthetic_clip(1.5, 44100, s)
                                         for s in (70, 71)], axis=1), 44100)
    a, b = one.compress(signal, win_duration=WINDOW_S, level=1.0), \
        two.compress(signal, win_duration=WINDOW_S, level=1.0)
    assert np.array_equal(a.codes, b.codes) and np.array_equal(a.vbr_counts, b.vbr_counts)
    np.testing.assert_allclose(two.decompress(b).audio_data, one.decompress(a).audio_data,
                               rtol=0, atol=1e-5)


def test_replicas_over_several_devices_are_copies_made_at_construction():
    """Every block of a batch is coded by the same weights: over several
    devices each replica (the first too) is a copy of the parameters when
    the processor was made; on its own device alone it is the model."""
    model = port.build_model(port.small_config(), device="cpu", seed=3)
    alone, two = port.CodecProcessor(model), port.CodecProcessor(model, devices=["cpu"] * 2)
    assert alone.replicas[0][0] is model
    with torch.no_grad():
        next(model.parameters()).add_(1.0)
    want = [p.detach().clone() for p in model.parameters()]
    for m, _ in two.replicas:
        assert m is not model
        got = list(m.parameters())
        assert not torch.equal(got[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(got[1:], want[1:]))


@pytest.mark.parametrize("hosts,host,cards,local", [(1, 0, 1, 0), (2, 1, 4, 3), (4, 2, 8, 5)])
def test_layout_maps_jax_flags_and_torchrun_alike(hosts, host, cards, local):
    """JAX's flags count hosts; torchrun counts processes. A process a card,
    both give rank host x cards + local of hosts x cards."""
    flags = pdist.layout("h0:1234", hosts, host, local, cards=cards, env={})
    env = pdist.layout(env={"RANK": str(flags.rank), "WORLD_SIZE": str(flags.world),
                            "LOCAL_RANK": str(local), "MASTER_ADDR": "h0",
                            "MASTER_PORT": "1234"})
    assert (flags.rank, flags.world, flags.local_rank) == \
        (env.rank, env.world, env.local_rank) == (host * cards + local, hosts * cards, local)
    assert flags.init_method == "tcp://h0:1234" and env.init_method == "env://"


def test_layout_refuses_what_it_cannot_place():
    with pytest.raises(ValueError, match="coordinator"):
        pdist.layout(num_processes=2, process_id=0, env={})
    with pytest.raises(ValueError, match="torchrun"):
        pdist.layout(env={})
    with pytest.raises(ValueError, match="process 2 of 2"):
        pdist.layout("h:1", 2, 2, env={})


def test_init_distributed_gives_each_process_its_rank_both_ways(tmp_path):
    """Two processes join a gloo group through torchrun's environment, then
    a second through JAX's flags (a host of one process each): the same
    ranks."""
    pdist.spawn(support.init_rank, 2, str(tmp_path), pdist.free_port(),
                backend="gloo", timeout=120)
    for r in range(2):
        views = torch.load(tmp_path / f"rank{r}.pt")
        assert views == {"env": (r, 2), "flags": (r, 2)}
