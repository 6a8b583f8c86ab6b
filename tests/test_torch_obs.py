"""The port's spans and counters (``vrvq_tpu_torch/utils.py``) and where the
program records them: the pools, the packets and the train step.

Port only, on the CPU: the pools at the tiny codec of
``test_torch_streaming.py`` (encoder 8, 4 codebooks of 32 x 4, 0.7 s
windows), drawn from a seed; the train step at ``test_torch_train_step.py``'s
small configuration, drawn from a seed, its draws pinned.
"""

import collections
import contextlib
import copy
import time

import numpy as np
import pytest
import torch

import vrvq_tpu_torch as port
from vrvq_tpu_torch import kernels, profile_serve, utils
from vrvq_tpu_torch.convert import init_params
from vrvq_tpu_torch.infer import streaming
from vrvq_tpu_torch.models.discriminator import Discriminator
from vrvq_tpu_torch.train import loop
from vrvq_tpu_torch.train import state as train_state
from vrvq_tpu_torch.train.state import TrainState, make_optimizer
from tests.test_torch_train_step import (
    DEPTHS, FFTS, LAMBDAS, PERIODS, SMALL, U, _audio, _losses)

torch.set_num_threads(1)

SIZES = dict(encoder_dim=8, codebook_size=32)
WIN = 0.7


@pytest.fixture(autouse=True)
def empty_ring():
    utils.reset()
    yield
    utils.reset()


def _names(recs):
    return [r.name for r in recs]


# ------------------------------------------------------------------ spans
def test_span_nesting_and_self_time():
    with utils.annotate("outer") as outer:
        time.sleep(0.002)
        with utils.annotate("inner.a"):
            time.sleep(0.004)
        with utils.annotate("inner.b"):
            time.sleep(0.003)
    recs = utils.records()
    assert _names(recs) == ["inner.a", "inner.b", "outer"]  # in the order they ended
    a, b, top = recs
    assert a.parent == b.parent == top.seq == outer.seq and top.parent == -1
    assert top.start_ns <= a.start_ns < a.end_ns <= b.start_ns < b.end_ns <= top.end_ns
    assert top.ns == outer.ns
    assert utils.self_ns([top]) == [top.ns - a.ns - b.ns]
    assert utils.self_ns([a, b]) == [a.ns, b.ns]
    assert 2e6 <= utils.self_ns([top])[0] < top.ns


def test_payload_set_inside_the_block_and_ids():
    with utils.annotate("packet.pack", stream=3, window=7) as span:
        span.payload = 42
    with utils.annotate("stream_pool.poll", payload=5):
        pass
    first, second = utils.records()
    assert (first.payload, first.ids) == (42, {"stream": 3, "window": 7})
    assert (second.payload, second.ids) == (5, None)


def test_add_span_lies_under_the_open_span():
    utils.add_span("alone", 10, 30, payload=2, stream="s")
    with utils.annotate("poll") as poll:
        utils.add_span("inside", 40, 50)
    alone, inside, _ = utils.records()
    assert (alone.parent, alone.ns, alone.payload, alone.ids) == (-1, 20, 2, {"stream": "s"})
    assert inside.parent == poll.seq


def test_span_records_when_its_block_raises():
    with pytest.raises(ValueError):
        with utils.annotate("fails"):
            raise ValueError("x")
    assert _names(utils.records()) == ["fails"]
    with utils.annotate("after") as after:
        pass
    assert after.parent == -1  # the failed span left the stack


@pytest.mark.parametrize("extra", [0, 1, 13])
def test_ring_keeps_the_newest_and_counts_dropped(monkeypatch, extra):
    ring = utils.Ring(8)
    monkeypatch.setattr(utils, "RING", ring)
    for i in range(8 + extra):
        with utils.annotate(f"s{i}"):
            pass
    assert ring.dropped == extra
    assert _names(utils.records()) == [f"s{i}" for i in range(extra, 8 + extra)]
    utils.reset()
    assert ring.dropped == 0 and utils.records() == []


def test_threads_record_their_own_nesting_and_lose_no_record(monkeypatch):
    """More threads than cores, switching often: every span is kept once,
    and each nests under its own thread's open span."""
    import sys
    import threading

    monkeypatch.setattr(utils, "RING", utils.Ring(1 << 16))
    n_threads, n_spans = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for i in range(n_spans):
                with utils.annotate(f"t{k}.outer"):
                    with utils.annotate(f"t{k}.inner", payload=i):
                        pass

        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    recs = utils.records()
    assert utils.RING.written == len(recs) == 2 * n_threads * n_spans
    assert len({r.seq for r in recs}) == len(recs)
    by_seq = {r.seq: r for r in recs}
    for r in recs:
        if r.name.endswith(".inner"):
            assert by_seq[r.parent].name == r.name.replace(".inner", ".outer")
        else:
            assert r.parent == -1


def test_records_by_name_and_time():
    for name, start, end in [("a", 0, 10), ("b", 5, 20), ("a", 30, 40), ("a", 50, 70)]:
        utils.add_span(name, start, end)
    assert [(r.start_ns, r.end_ns) for r in utils.records("a")] == [(0, 10), (30, 40), (50, 70)]
    assert [r.start_ns for r in utils.records("a", since_ns=5)] == [30, 50]
    assert [r.start_ns for r in utils.records("a", until_ns=40)] == [0, 30]
    assert [r.name for r in utils.records(since_ns=5, until_ns=40)] == ["b", "a"]


def test_counters_and_kernel_launches_are_one_table():
    assert kernels.LAUNCHES is utils.counter("launches")
    utils.count("launches.snake")
    utils.count("launches.rvq", 3)
    utils.count("packets.bytes", 100)
    assert dict(kernels.LAUNCHES) == {"snake": 1, "rvq": 3}
    assert utils.COUNTERS["packets"] == {"bytes": 100}
    launches = kernels.LAUNCHES
    utils.reset()
    assert kernels.LAUNCHES is launches and not launches and not utils.COUNTERS["packets"]


# ------------------------------------------------------------- profiler
def test_record_function_entered_only_under_the_profiler(monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function

    def spy(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", spy)
    with utils.annotate("stream_pool.poll"):
        torch.ones(4).sum()
    assert entered == []
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with utils.annotate("stream_pool.poll"):
            with utils.annotate("stream_pool.poll.fetch"):
                torch.ones(4).sum()
    assert entered == ["vrvq.stream_pool.poll", "vrvq.stream_pool.poll.fetch"]
    names = {e.name for e in prof.events()}
    assert {"vrvq.stream_pool.poll", "vrvq.stream_pool.poll.fetch"} <= names
    with utils.annotate("after"):
        pass
    assert len(entered) == 2
    assert len(utils.records()) == 4  # recorded with and without the profiler


def _host(name, start, end):
    return (utils.PREFIX + name, False, True, start, end)


def _device(start, end, name="kernel"):
    return (name, True, False, start, end)


def test_idle_split_over_the_innermost_span():
    events = [
        _host("step", 0, 100), _host("step.disc", 20, 60),
        _host("clip_sync", 45, 60),
        _device(0, 10), _device(30, 40), _device(35, 45), _device(90, 95),
        # a device annotation is no operation
        ("vrvq.step", True, True, 0, 100), ("Optimizer.step#AdamW.step", True, True, 60, 90),
    ]
    idle = utils.idle_split(events)
    assert idle == pytest.approx({"step": (20 - 10 + 90 - 60 + 100 - 95) / 1e9,
                                  "step.disc": (30 - 20) / 1e9,
                                  "clip_sync": (60 - 45) / 1e9})


def test_idle_split_gap_over_two_host_spans():
    """One gap, from 10 to 70, over two spans one after the other and a
    stretch with none: each gets its own part of it, not the whole gap by
    where it began."""
    events = [_device(0, 10), _host("stream_pool.poll", 5, 30),
              _host("decoder_pool.poll", 30, 50), _device(70, 80)]
    idle = utils.idle_split(events)
    assert idle == pytest.approx({"stream_pool.poll": 20e-9, "decoder_pool.poll": 20e-9,
                                  utils.NO_SPAN: 20e-9})
    assert sum(idle.values()) == pytest.approx(60e-9)


def test_idle_split_ties_and_empty():
    assert utils.idle_split([]) == {}
    # two spans begun at once: the shorter is the inner one
    events = [_host("outer", 0, 50), _host("inner", 0, 20), _device(40, 50)]
    assert utils.idle_split(events) == pytest.approx({"inner": 20e-9, "outer": 20e-9})


def test_idle_by_span_reads_a_profile():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with utils.annotate("outer"):
            time.sleep(0.002)
            with utils.annotate("inner"):
                time.sleep(0.003)
    idle = utils.idle_by_span(prof)  # no device: all of it idle
    outer, = utils.records("outer")
    inner, = utils.records("inner")
    assert set(idle) == {"outer", "inner"}
    assert idle["inner"] == pytest.approx(inner.ns / 1e9, rel=0.2)
    assert sum(idle.values()) == pytest.approx(outer.ns / 1e9, rel=0.2)


class _FakeEvent:
    def __init__(self, name, cuda, start, end, annotation=False):
        self._args = name, cuda, start, end, annotation

    def name(self):
        return self._args[0]

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._args[1] else torch.autograd.DeviceType.CPU

    def start_ns(self):
        return self._args[2]

    def duration_ns(self):
        return self._args[3] - self._args[2]

    def is_user_annotation(self):
        return self._args[4]


def _fake_profile(events):
    results = type("R", (), {"events": lambda self: events})()
    return type("P", (), {"profiler": type("K", (), {"kineto_results": results})()})()


def test_device_summary_busy_share_is_the_union():
    """Kernels on two streams overlap: busy is the union of their intervals
    (25 ns of 40), while the time by class sums them."""
    prof = _fake_profile([
        _FakeEvent("conv_fprop", True, 0, 10_000), _FakeEvent("elementwise", True, 5_000, 15_000),
        _FakeEvent("snake_kernel", True, 20_000, 30_000),
        _FakeEvent("vrvq.stream_pool.poll", False, 0, 40_000, True),
        _FakeEvent("vrvq.stream_pool.poll", True, 0, 30_000, True),
    ])
    out = profile_serve.device_summary(prof, 40e-6)
    assert out["device_busy_share"] == pytest.approx(25 / 40)
    assert out["device_ms"] == pytest.approx(0.030)
    assert out["device_kernels"] == 3
    assert out["device_ms_by_class"] == pytest.approx(
        {"conv": 0.01, "elementwise": 0.01, "snake (K2)": 0.01})
    assert out["idle_ms_by_span"] == pytest.approx({"stream_pool.poll": 0.015})


# ---------------------------------------------------------------- pools
@pytest.fixture(scope="module")
def proc():
    model = port.build_model(port.small_config(**SIZES), device="cpu", seed=0)
    return port.CodecProcessor(model, fused_quantizer=True)


def _tone(seconds, shift=0):
    t = (np.arange(int(seconds * 44100)) + shift) / 44100
    return (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)


def test_pools_and_packets_record_windows_rows_waits_and_bytes(proc):
    pool = streaming.StreamPool(proc, win_duration=WIN, level=1.0, max_batch=4)
    dpool = streaming.DecoderPool(proc, win_duration=WIN, max_batch=4)
    tx = {s: streaming.PacketCodec(4, 32) for s in "abc"}
    rx = {s: streaming.PacketCodec(4, 32) for s in "abc"}
    for s in "abc":
        pool.add_stream(s)
        pool.push(s, _tone(1.6, 1000 * ord(s)))
    held = time.perf_counter_ns()
    time.sleep(0.02)  # the windows wait 20 ms for their poll
    got = pool.poll()
    packets = []
    for s, codes, counts in got:
        packet = tx[s].pack(codes, counts)
        packets.append(packet)
        dpool.push(s, *rx[s].unpack(packet))
    back = dpool.poll()
    assert len(got) == len(back) > 4  # more than one batch

    def padded(n):  # batches of at most 4, each to a power of two
        return sum(1 << (min(4, n - i) - 1).bit_length() for i in range(0, n, 4))

    for pool_name in ("stream_pool.poll", "decoder_pool.poll"):
        poll, = utils.records(pool_name)
        assert poll.payload == len(got)
        kids = [r for r in utils.records() if r.parent == poll.seq]
        assert _names(kids) == [pool_name + p for p in (".stack", ".put", ".launch", ".fetch")]
        assert kids[1].payload == padded(len(got))
        assert all(poll.start_ns <= k.start_ns <= k.end_ns <= poll.end_ns for k in kids)
    waits = utils.records("stream_pool.wait")
    poll, = utils.records("stream_pool.poll")
    assert len(waits) == len(got)
    assert all(w.end_ns == poll.start_ns and w.start_ns <= held and w.ns >= 20e6 for w in waits)
    per_stream = collections.defaultdict(list)
    for w in waits:
        per_stream[w.ids["stream"]].append(w.ids["window"])
    assert {s: sorted(v) for s, v in per_stream.items()} == {
        s: list(range(sum(1 for g in got if g[0] == s))) for s in "abc"}
    assert [r.payload for r in utils.records("packet.pack")] == [len(p) for p in packets]
    assert [r.payload for r in utils.records("packet.unpack")] == [len(p) for p in packets]


def test_wait_records_index_windows_across_polls_and_flush(proc):
    """A stream's window index runs on over polls and its flush; an empty
    poll records nothing."""
    pool = streaming.StreamPool(proc, win_duration=WIN, level=1.0, max_batch=8)
    pool.add_stream("s")
    assert pool.poll() == [] and utils.records() == []
    x = _tone(2.5)
    seen = []
    for part in np.array_split(x, 3):
        pool.push("s", part)
        seen += pool.poll()
    pool.flush("s")
    seen += pool.poll()
    windows = [w.ids["window"] for w in utils.records("stream_pool.wait")]
    assert windows == list(range(len(seen)))
    assert sum(r.payload for r in utils.records("stream_pool.poll")) == len(seen)


# ------------------------------------------------------------ train step
def _state():
    draw = torch.Generator().manual_seed(0)
    gen = init_params(port.DAC_VRVQ(port.small_config(**SMALL)), draw)
    disc = init_params(Discriminator(periods=PERIODS, fft_sizes=FFTS), draw)
    return TrainState(gen, disc, make_optimizer(gen.parameters(), max_grad_norm=1e3),
                      make_optimizer(disc.parameters(), max_grad_norm=10.0))


class _NoSpan:
    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _step(state, monkeypatch=None, profiled=False):
    stft_t, mel_t, wave_t = _losses(False)
    train_step = loop.make_train_step(LAMBDAS, stft_t, mel_t, wave_t)
    levels = state.generator.quantizer.random_levels(torch.from_numpy(U))
    ctx = (torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
           if profiled else contextlib.nullcontext())
    with ctx:
        return train_step(state, torch.from_numpy(_audio()), levels=levels, depths=DEPTHS)


@pytest.fixture(scope="module")
def three_steps():
    """The step from one state three times: without spans (as the step was
    before it had any), with them, and with them under the profiler."""
    base = _state()
    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(loop, "annotate", _NoSpan)
    mp.setattr(train_state, "annotate", _NoSpan)
    try:
        st = copy.deepcopy(base)
        out["plain"] = (st, _step(st), [])
    finally:
        mp.undo()
    for key, profiled in (("spans", False), ("profiled", True)):
        utils.reset()
        st = copy.deepcopy(base)
        out[key] = (st, _step(st, profiled=profiled), utils.records())
    return out


def test_train_step_records_its_phases_in_order(three_steps):
    _, _, recs = three_steps["spans"]
    step, = [r for r in recs if r.name == "train.step"]
    phases = sorted((r for r in recs if r.parent == step.seq), key=lambda r: r.start_ns)
    assert _names(phases) == ["train.forward", "train.disc", "train.gen_losses",
                              "train.gen_backward", "train.gen_update"]
    for a, b in zip(phases, phases[1:]):
        assert a.end_ns <= b.start_ns
    syncs = [r for r in recs if r.name == "clip_sync"]
    by_seq = {r.seq: r.name for r in recs}
    assert [by_seq[r.parent] for r in syncs] == ["train.disc", "train.gen_update"]
    assert sum(r.ns for r in phases) <= step.ns


def test_train_step_spans_leave_the_bits_unchanged(three_steps):
    plain_state, plain, _ = three_steps["plain"]
    for key in ("spans", "profiled"):
        st, metrics, recs = three_steps[key]
        assert recs, key
        assert list(metrics) == list(plain)
        for name, value in metrics.items():
            assert torch.isfinite(value) and torch.equal(value, plain[name]), (key, name)
        for net in ("generator", "discriminator"):
            for (n, p), q in zip(getattr(st, net).named_parameters(),
                                 getattr(plain_state, net).parameters()):
                assert torch.equal(p, q), (key, net, n)
        assert st.step == plain_state.step == 1
