"""The readers of the program's span records: which part of a run's
window they read, what each reads there, that a program without records
gives no number, and that a traced run on the CPU reports them."""

import builtins
import types

import pytest

from codec_bench import harness, program_spans
from codec_bench.tests.helpers import cell_run

utils = pytest.importorskip("vrvq_tpu_torch.utils")

LIVE = ("pool_wait_ms.live", "encode_poll_ms.live", "decode_poll_ms.live",
        "pool_launch_ms.live", "packet_host_ms.live", "pool_pad_share.live")
TRAIN = ("disc_phase_ms.train", "gen_phase_ms.train")
S = 1_000_000_000  # ns a second


def _live_run(trace=True):
    return types.SimpleNamespace(rest=None, started=100.0, setup_s=10.0, seconds=51.0,
                                 trace=trace, mix={"warmup_s": 3.0, "trace_s": 8.0},
                                 counters={})


def _train_run():
    return types.SimpleNamespace(rest=(200.0, 12), started=100.0, setup_s=20.0, seconds=51.0,
                                 trace=True, mix={"trace_s": 4.0},
                                 counters={"rest_s": 47.0, "rest_units": 75})


def test_untraced_part_of_a_window_traced_last():
    lo, hi = program_spans.untraced_ns(_live_run())
    assert lo == int(113.05 * S) and hi == int((113.05 + 51 - 8) * S)
    lo, hi = program_spans.untraced_ns(_live_run(trace=False))
    assert hi == int((113.05 + 51) * S)


def test_untraced_part_of_a_window_traced_first():
    assert program_spans.untraced_ns(_train_run()) == (200 * S, 247 * S)


@pytest.fixture()
def ring(monkeypatch):
    ring = utils.Ring(256)
    monkeypatch.setattr(utils, "RING", ring)
    seq = iter(range(10 ** 6))

    def add(name, start_s, end_s, parent=-1, payload=None, **ids):
        n = next(seq)
        ring.add((n, name, int(start_s * S), int(end_s * S), parent, payload, ids or None))
        return n

    return add


def _read(metric, run):
    return harness.reader(metric)(run)


def _poll(add, t, windows, rows, enc=True):
    """A poll at ``t`` s of 40 ms with 4 children, its launch 10 ms."""
    pool = "stream_pool" if enc else "decoder_pool"
    p = add(f"{pool}.poll", t, t + 0.040, payload=windows)
    add(f"{pool}.poll.stack", t, t + 0.005, p)
    add(f"{pool}.poll.put", t + 0.005, t + 0.010, p, payload=rows)
    add(f"{pool}.poll.launch", t + 0.010, t + 0.020, p)
    add(f"{pool}.poll.fetch", t + 0.020, t + 0.040, p)


def test_live_readers_read_the_untraced_part(ring):
    run = _live_run()  # untraced from 113.05 s to 156.05 s
    for t, inside in ((112.9, False), (120.0, True), (130.0, True), (161.0, False)):
        k = 1 if inside else 100  # records outside the part would move every number
        _poll(ring, t, 6 * k, 8 * k)
        ring("stream_pool.wait", t - 0.05 * k, t, stream=0, window=int(t))
        ring("packet.pack", t + 0.041, t + 0.041 + 0.001 * k, payload=300)
        ring("packet.unpack", t + 0.043, t + 0.043 + 0.002 * k, payload=300)
        _poll(ring, t + 0.05, 6 * k, 16 * k, enc=False)
    got = {m: _read(m, run) for m in LIVE}
    assert got == pytest.approx({
        "pool_wait_ms.live": 50.0, "encode_poll_ms.live": 40.0, "decode_poll_ms.live": 40.0,
        "pool_launch_ms.live": 20.0, "packet_host_ms.live": 3.0,
        "pool_pad_share.live": 100.0 * (24 - 12) / 24})


def test_pool_launch_is_self_time(ring):
    run = _live_run()
    p = ring("stream_pool.poll", 120.0, 120.1, payload=1)
    launch = ring("stream_pool.poll.launch", 120.0, 120.05, p)
    ring("inner", 120.0, 120.02, launch)  # a span inside the launch is not its own time
    assert _read("pool_launch_ms.live", run) == pytest.approx(30.0)


def test_train_readers_read_the_untraced_part(ring):
    run = _train_run()  # untraced from 200 s to 247 s
    # a step that began before the part: its phases inside it are not read
    for t, inside in ((199.0, False), (210.0, True), (211.0, True), (246.9, False)):
        k = 1 if inside else 50
        s = ring("train.step", t, t + 0.6 * k)
        ring("train.forward", t, t + 0.1 * k, s)
        ring("train.disc", t + 0.1 * k, t + 0.3 * k, s)
        ring("train.gen_losses", t + 0.3 * k, t + 0.4 * k, s)
        ring("train.gen_backward", t + 0.4 * k, t + 0.55 * k, s)
        ring("train.gen_update", t + 0.55 * k, t + 0.6 * k, s)
    assert _read("disc_phase_ms.train", run) == pytest.approx(300.0)
    assert _read("gen_phase_ms.train", run) == pytest.approx(300.0)


@pytest.mark.parametrize("metric", LIVE + TRAIN)
def test_no_records_no_number(ring, metric):
    run = _live_run() if metric.endswith(".live") else _train_run()
    assert _read(metric, run) is None


@pytest.mark.parametrize("metric", LIVE + TRAIN)
def test_a_program_without_records_gives_none(monkeypatch, metric):
    """The parent program's ``utils`` has no ``records``: the reader leaves
    its metric out rather than raising."""
    real = builtins.__import__
    bare = types.ModuleType("vrvq_tpu_torch.utils")

    def fake(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "vrvq_tpu_torch.utils":
            return bare
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", fake)
    run = _live_run() if metric.endswith(".live") else _train_run()
    assert _read(metric, run) is None


@pytest.mark.parametrize("workload,names,seconds", [("vrvq_a2.live_streams", LIVE, 3.0),
                                                    ("vrvq_a2.train_b16", TRAIN, 4.0)])
def test_traced_cpu_run_reports_the_program_metrics(workload, names, seconds):
    """Long enough for polls and steps after the trace (the CPU steps are
    slow)."""
    utils.reset()
    run = cell_run(workload, trace=True, seconds=seconds)
    out = harness.result(run, harness.spec())
    assert set(names) <= set(out["metrics"]), out["metrics"]
    assert all(out["metrics"][n]["value"] >= 0 for n in names)
