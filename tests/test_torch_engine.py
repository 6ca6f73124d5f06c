"""The histogram / shot-detection slice end to end: the same clip, ingested
into one database per package, run through the JAX package's Client and
the PyTorch port's Client(device="cpu"); the stored rows must be
bit-identical (tolerance 0: the item bytes are compared).

Mirrors tests/test_engine.py and tests/test_bucketing.py: whole streams,
a ragged Range whose tail packet sits below the top bucket, and a Stride
sampling.  The port is also driven with its device staging on over CPU
tensors, which runs the tensor path the card takes (pinned staging is
skipped on the CPU, the YUV420 wire converts with torch, the histogram
wrapper takes its plain version)."""

import gc

import numpy as np
import pytest
import torch

import scanner_tpu as sj
import scanner_tpu.kernels  # noqa: F401  (registers the stdlib ops)
from scanner_tpu import video as scv
from scanner_tpu.engine import framecache as jfc

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.engine.executor import LocalExecutor
from scanner_tpu_torch.util.profiler import Profiler
from torch_model_checks import stop_process_engine  # noqa: F401

N, W, H = 48, 128, 96


@pytest.fixture(autouse=True, scope="module")
def _release_jax_frame_cache():
    """Clear the JAX package's frame cache after this file: its pages
    are live entries of the JAX allocation ledger, which a later file in
    the same worker process reads (tests/test_memstats.py)."""
    yield
    jfc.cache().clear()
    gc.collect()


@pytest.fixture(scope="module")
def clients(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_engine")
    clip = str(root / "clip.mp4")
    scv.synthesize_video(clip, num_frames=N, width=W, height=H, fps=24,
                         keyint=8)
    cj = sj.Client(db_path=str(root / "db_jax"))
    ct = st.Client(db_path=str(root / "db_torch"), device="cpu")
    _, failed = cj.ingest_videos([("clip", clip)])
    assert not failed
    _, failed = ct.ingest_videos([("clip", clip)])
    assert not failed
    yield cj, ct
    cj.stop()
    ct.stop()


def _graph(sc, pkg, kind, sampling, out_name):
    frame = sc.io.Input([pkg.NamedVideoStream(sc, "clip")])
    if sampling == "range":
        frame = sc.streams.Range(frame, [(3, 24)])    # 21 rows: 16 + 5
    elif sampling == "stride":
        frame = sc.streams.Stride(frame, [3])
    if kind == "config1":
        col = sc.ops.Histogram(frame=frame)
    elif kind == "config2":
        col = sc.ops.HistogramDelta(hist=sc.ops.Histogram(frame=frame))
    else:
        col = sc.ops.ShotBoundary(diff=sc.ops.HistDiff(frame=frame),
                                  threshold=[1000.0])
    return sc.io.Output(col, [pkg.NamedStream(sc, out_name)])


def _stored(db, table):
    desc = db.table_descriptor(table)
    col = desc.columns[0].name
    return list(db.load_column(table, col))


CASES = [(k, s) for k in ("config1", "config2", "histdiff")
         for s in ("all", "range", "stride")]


@pytest.mark.parametrize("kind,sampling", CASES)
def test_port_matches_jax_bit_exact(clients, kind, sampling):
    cj, ct = clients
    name = f"{kind}_{sampling}"
    perf = dict(work_packet_size=8, io_packet_size=16)
    cj.run(_graph(cj, sj, kind, sampling, name),
           sj.PerfParams.manual(**perf), show_progress=False)
    ct.run(_graph(ct, st, kind, sampling, name),
           st.PerfParams.manual(**perf), show_progress=False)
    want = _stored(cj._db, name)
    got = _stored(ct._db, name)
    assert len(got) == len(want) > 0
    assert got == want


@pytest.mark.parametrize("kind", ["config1", "histdiff"])
def test_port_tensor_path_matches_jax(clients, kind, monkeypatch):
    """Device staging on over CPU tensors: the tensor path of the card
    (YUV420 wire converted by torch, kernels on tensors) stores the same
    bytes as the JAX package on its YUV420 wire (which its CPU backend
    takes only when forced)."""
    cj, ct = clients
    name = f"{kind}_staged"
    perf = dict(work_packet_size=8, io_packet_size=16)
    with monkeypatch.context() as m:
        m.setenv("SCANNER_TPU_YUV_DEVICE", "force")
        cj.run(_graph(cj, sj, kind, "range", name),
               sj.PerfParams.manual(**perf), show_progress=False)
    ex = LocalExecutor(ct._db, Profiler(), torch.device("cpu"), stage=True)
    ex.run([_graph(ct, st, kind, "range", name)],
           st.PerfParams.manual(**perf))
    assert _stored(ct._db, name) == _stored(cj._db, name)


def test_port_reads_histograms_back(clients):
    """The stored config-1 rows load back as (3, 16) int32 histograms
    whose counts sum to the frame's pixel count."""
    _, ct = clients
    ct.run(_graph(ct, st, "config1", "all", "hist_back"),
           st.PerfParams.manual(8, 16), show_progress=False)
    rows = list(st.NamedStream(ct, "hist_back").load())
    assert len(rows) == N
    for r in rows:
        assert r.dtype == np.int32 and r.shape == (3, 16)
        assert (r.sum(axis=1) == W * H).all()


def test_frame_table_source_matches_video_source(clients):
    """A stored table of pickled frames (Client.new_table with a pickle
    codec) feeds the same Client.run -> Histogram path as a video stream
    decoded to the same frames."""
    _, ct = clients
    frames = list(st.NamedVideoStream(ct, "clip").load())
    ct.new_table("clip_frames", ["frame"], [[f] for f in frames],
                 overwrite=True, codecs={"frame": "pickle"})
    src = ct.io.Input([st.NamedStream(ct, "clip_frames")])
    ct.run(ct.io.Output(ct.ops.Histogram(frame=src),
                        [st.NamedStream(ct, "hist_table")]),
           st.PerfParams.manual(8, 16), show_progress=False)
    ct.run(_graph(ct, st, "config1", "all", "hist_video"),
           st.PerfParams.manual(8, 16), show_progress=False)
    assert _stored(ct._db, "hist_table") == _stored(ct._db, "hist_video")


@pytest.mark.parametrize("kind,staged", [("config1", False),
                                         ("histdiff", False),
                                         ("config2", True),
                                         ("histdiff", True)])
def test_serial_path_matches_pipelined_and_jax(clients, kind, staged,
                                               monkeypatch):
    """SCANNER_TPU_NO_PIPELINING=1 runs every stage inline on one thread
    through the same evaluator; its stored rows equal the pipelined
    run's and the JAX package's, on the host path and on the tensor
    path (device staging over CPU tensors, through the frame cache)."""
    cj, ct = clients
    perf = dict(work_packet_size=8, io_packet_size=16)
    name = f"{kind}_{'staged' if staged else 'host'}"
    with monkeypatch.context() as m:
        if staged:
            m.setenv("SCANNER_TPU_YUV_DEVICE", "force")
        cj.run(_graph(cj, sj, kind, "range", f"{name}_jax"),
               sj.PerfParams.manual(**perf), show_progress=False)

    def run(out, serial):
        with monkeypatch.context() as m:
            if serial:
                m.setenv("SCANNER_TPU_NO_PIPELINING", "1")
            if staged:
                ex = LocalExecutor(ct._db, Profiler(), torch.device("cpu"),
                                   stage=True)
                ex.run([_graph(ct, st, kind, "range", out)],
                       st.PerfParams.manual(**perf))
            else:
                ct.run(_graph(ct, st, kind, "range", out),
                       st.PerfParams.manual(**perf), show_progress=False)
        return _stored(ct._db, out)

    serial = run(f"{name}_serial", True)
    piped = run(f"{name}_piped", False)
    assert len(serial) == 21
    assert serial == piped == _stored(cj._db, f"{name}_jax")
