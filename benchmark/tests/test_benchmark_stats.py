"""The end-to-end arithmetic: all the work over all the time, and the
tail of all the jobs, with no medians of chunks."""

import statistics

import pytest

from bench_tiny import REPO  # noqa: F401  (puts the repository on the path)
from benchmark import run
from benchmark.harness import stats, traffic
from benchmark.harness.window import Job, Window


def test_percentile_nearest_rank():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 90) == 90
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([3, 1, 2], 50) == 2
    with pytest.raises(ValueError):
        stats.percentile([], 90)


@pytest.mark.parametrize("n,q", [(100, 90.0), (150, 90.0), (50, 80.0),
                                 (10, 100.0), (11, 100.0 / 11)])
def test_tail_percentile_leaves_ten_beyond(n, q):
    assert stats.tail_percentile(n, 90) == pytest.approx(q)
    if n > 10:
        xs = list(range(n))
        p = stats.percentile(xs, stats.tail_percentile(n, 90))
        assert sum(1 for x in xs if x > p) >= 10


def test_rate():
    assert stats.rate(600, 1.5) == 400
    with pytest.raises(ValueError):
        stats.rate(1, 0)


class _Cell:
    config, reference = {}, None


def _record(walls, frames=96, gap=0.0):
    jobs, t = [], 100.0
    for i, w in enumerate(walls):
        jobs.append(Job(i, (0, frames), f"out_{i}", t0=t, t1=t + w))
        t += w + gap
    win = Window(jobs, jobs[0].t0, jobs[-1].t1)
    rec = run.Record.__new__(run.Record)
    rec.cell, rec.window, rec.jobs, rec.setup_s = _Cell(), win, jobs, 12.5
    return rec


def test_frames_per_s_is_all_frames_over_all_time():
    """Uneven jobs: the rate is the sum of frames over the window's
    seconds, not a mean of per-job rates."""
    rec = _record([0.5, 1.5, 1.0], gap=0.5)
    assert run.end_to_end("frames_per_s", rec) == pytest.approx(
        3 * 96 / (0.5 + 1.5 + 1.0 + 2 * 0.5))
    per_job = statistics.mean(96 / w for w in (0.5, 1.5, 1.0))
    assert run.end_to_end("frames_per_s", rec) != pytest.approx(per_job)


def test_job_p90_is_the_tail_of_all_jobs():
    walls = [0.4] * 90 + [0.9] * 10 + [1.5] * 10
    rec = _record(walls)
    # 110 jobs: the 90th percentile by rank 99 lies in the 0.9 group
    assert run.end_to_end("job_p90_s", rec) == pytest.approx(0.9)
    assert run.end_to_end("setup_s", rec) == 12.5


def test_window_holds_every_job_sent():
    rec = _record([0.3] * 5)
    assert rec.window.seconds == pytest.approx(1.5)
    assert rec.frames == 5 * 96


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 3, 2 ** 40 + 1])
def test_traffic_same_clips_every_seed(seed):
    mix = {"loop": "closed", "clients": 1, "frames_per_job": 96}
    order = traffic.job_order(mix, 600, seed)
    first = [next(order) for _ in range(12)]
    assert sorted(first[:6]) == sorted(first[6:]) == traffic.clips(mix, 600)
    assert traffic.clips(mix, 600) == [(k * 96, (k + 1) * 96)
                                       for k in range(6)]


def test_trace_busy_idle_and_labels(tmp_path):
    """A synthetic exported trace: the marker sets the clock, device
    events merge into busy spans, idle gaps are named by the host spans
    open over them."""
    import json

    from benchmark.harness import trace
    evs = [{"name": trace.ANCHOR, "ph": "X", "cat": "user_annotation",
            "ts": 1_000_000.0, "dur": 1.0},
           {"name": "k1", "ph": "X", "cat": "kernel", "ts": 1_100_000.0,
            "dur": 200_000.0},
           {"name": "copy", "ph": "X", "cat": "gpu_memcpy",
            "ts": 1_200_000.0, "dur": 200_000.0},
           {"name": "cpu", "ph": "X", "cat": "cpu_op", "ts": 1_500_000.0,
            "dur": 100_000.0}]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": evs}))
    tr = trace.read_chrome_trace(str(path), 50.0, 51.0)
    assert tr.window_s == 1.0
    assert tr.busy == [(pytest.approx(50.1), pytest.approx(50.4))]
    assert tr.busy_s == pytest.approx(0.3)
    assert tr.seconds_by_name() == {"k1": pytest.approx(0.2),
                                    "copy": pytest.approx(0.2)}
    gaps = tr.idle_gaps()
    assert [(round(a, 6), round(b, 6)) for a, b in gaps] == \
        [(50.0, 50.1), (50.4, 51.0)]
    spans = [(50.0, 51.0, "client"), (50.5, 50.7, "load")]
    named = trace.label_gaps(gaps, spans, "harness", "client")
    assert named == {"client": pytest.approx(0.5),
                     "load": pytest.approx(0.2)}
    assert sum(named.values()) == pytest.approx(1.0 - tr.busy_s)
    path.write_text(json.dumps({"traceEvents": evs[1:]}))
    assert trace.read_chrome_trace(str(path), 50.0, 51.0) is None
