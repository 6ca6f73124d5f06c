"""The stored database is the state the two packages share: a table
written by the port is read by the JAX package, and the other way round
(plain tables, pickled-frame tables, job outputs, ingested video)."""

import numpy as np
import pytest

import scanner_tpu as sj
import scanner_tpu.kernels  # noqa: F401
from scanner_tpu import video as jvideo
from scanner_tpu.storage import Database as JDatabase
from scanner_tpu.storage import PosixStorage as JPosix

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch import video as tvideo
from scanner_tpu_torch.storage import Database as TDatabase
from scanner_tpu_torch.storage import PosixStorage as TPosix
from torch_model_checks import stop_process_engine  # noqa: F401

ROWS = [[b"r00", b"r01"], [b"r10", b"r11"], [b"r20", b"r21"]]


def _jdb(path):
    db = JDatabase(JPosix(path))
    db.load_megafile()
    return db


def _tdb(path):
    db = TDatabase(TPosix(path))
    db.load_megafile()
    return db


def test_port_table_read_by_jax(tmp_path):
    db = str(tmp_path / "db")
    ct = st.Client(db_path=db, device="cpu")
    ct.new_table("plain", ["a", "b"], ROWS)
    rng = np.random.RandomState(0)
    frames = [rng.randint(0, 256, (6, 5, 3)).astype(np.uint8)
              for _ in range(4)]
    ct.new_table("frames", ["frame"], [[f] for f in frames],
                 codecs={"frame": "pickle"})
    jdb = _jdb(db)
    assert list(jdb.load_column("plain", "b")) == [r[1] for r in ROWS]
    cj = sj.Client(db_path=db)
    got = list(sj.NamedStream(cj, "frames").load())
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, f)
    assert len(got) == len(frames)


def test_jax_table_read_by_port(tmp_path):
    db = str(tmp_path / "db")
    cj = sj.Client(db_path=db)
    cj.new_table("plain", ["a", "b"], ROWS)
    tdb = _tdb(db)
    assert list(tdb.load_column("plain", "a")) == [r[0] for r in ROWS]
    ct = st.Client(db_path=db, device="cpu")
    assert ct.table("plain").num_rows() == len(ROWS)
    assert ct.table("plain").column_names() == ["a", "b"]


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("torch_storage") / "clip.mp4")
    jvideo.synthesize_video(p, num_frames=16, width=64, height=48, fps=24,
                            keyint=8)
    return p


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_video_and_job_output_cross_read(tmp_path, clip, writer):
    """One package ingests a clip and runs a Histogram job into it; the
    other decodes the same frames and loads the same histograms."""
    db = str(tmp_path / "db")
    pw, pr = (sj, st) if writer == "jax" else (st, sj)
    vw, vr = (jvideo, tvideo) if writer == "jax" else (tvideo, jvideo)
    kw = {} if writer == "jax" else {"device": "cpu"}
    cw = pw.Client(db_path=db, **kw)
    cw.ingest_videos([("clip", clip)])
    f = cw.io.Input([pw.NamedVideoStream(cw, "clip")])
    cw.run(cw.io.Output(cw.ops.Histogram(frame=f),
                        [pw.NamedStream(cw, "hist")]),
           pw.PerfParams.manual(4, 8), show_progress=False)
    written = list(pw.NamedStream(cw, "hist").load())
    frames_w = vw.load_frames(cw._db, "clip", [0, 7, 15])

    kr = {"device": "cpu"} if writer == "jax" else {}
    cr = pr.Client(db_path=db, **kr)
    read = list(pr.NamedStream(cr, "hist").load())
    assert len(read) == len(written) == 16
    for a, b in zip(read, written):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(vr.load_frames(cr._db, "clip", [0, 7, 15]),
                                  frames_w)
