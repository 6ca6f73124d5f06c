"""The loader's decode of a `pickle` column straight into one batch
(`storage/streams.py` `decode_rows_into`): byte for byte what unpickling
every row and stacking them gives, on rows whose layout it learns and on
rows that take `pickle.loads`; the counters the loader keeps of each; a
streamed Histogram job over a pickled table on the CPU against the JAX
package; and, on a card, a streamed job whose batches come from pinned
memory and ship with no copy of their own."""

import pickle

import numpy as np
import pytest
import torch

import scanner_tpu as sj
import scanner_tpu.kernels  # noqa: F401  (registers the stdlib ops)

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.common import NullElement
from scanner_tpu_torch.engine import batch as _batch
from scanner_tpu_torch.engine.batch import ColumnBatch
from scanner_tpu_torch.kernels.imgproc import histogram_np
from scanner_tpu_torch.storage.items import RowBuffer
from scanner_tpu_torch.storage.streams import decode_element, decode_rows_into

_RNG = np.random.default_rng(22)


def _frames(n, shape=(12, 16, 3), dtype=np.uint8):
    return [_RNG.integers(0, 256, shape).astype(dtype) for _ in range(n)]


def _dumps(objs, protocol=5):
    return [None if o is None else pickle.dumps(o, protocol=protocol)
            for o in objs]


def _in_row_buffer(blobs):
    """The blobs as views into one RowBuffer, as `read_rows_into` hands
    them out."""
    buf = RowBuffer()
    buf.start()
    views = []
    for b in blobs:
        v = buf.take(len(b))
        v[:] = b
        views.append(v)
    return views


def _mixed():
    f = _frames(4)
    return _dumps(f[:2], 4) + _dumps(f[2:], 5)


def _black_bottom():
    f = _frames(3)
    for x in f:
        x[-2:] = 0
    return _dumps([np.zeros_like(f[0])] + f)


def _int8_among_uint8(protocol):
    f = _frames(4)
    f[2] = f[2].astype(np.int8)
    return _dumps(f, protocol)


# name -> (rows as stored, direct rows, generic rows)
CASES = {
    "uniform_p4": (lambda: _dumps(_frames(6), 4), 6, 0),
    "uniform_p5": (lambda: _dumps(_frames(6), 5), 6, 0),
    # protocol 4 rows learn the layout; the protocol 5 ones differ in
    # length and prefix, so they unpickle into their slots
    "mixed_protocols": (_mixed, 2, 2),
    "null_row": (lambda: _dumps(_frames(2) + [None] + _frames(2)), 4, 0),
    "first_row_null": (lambda: _dumps([None] + _frames(3)), 3, 0),
    "all_null": (lambda: [None, None], 0, 0),
    # the list path: the rows before it stay in the batch's slots
    "other_shape": (lambda: _dumps(_frames(3) + _frames(1, (5, 4, 3))
                                   + _frames(1)), 3, 2),
    "other_dtype": (lambda: _dumps(_frames(2) + _frames(1, dtype=np.int16)
                                   + _frames(1)), 2, 2),
    "fortran": (lambda: _dumps([np.asfortranarray(f) for f in _frames(4)]),
                0, 4),
    "non_array": (lambda: _dumps([{"a": 1}, (2, 3), "x"]), 0, 3),
    "non_array_later": (lambda: _dumps(_frames(2) + [{"a": 1}]), 2, 1),
    "one_row": (lambda: _dumps(_frames(1)), 1, 0),
    "float32_rows": (lambda: _dumps(_frames(3, (5, 7), np.float32)), 3, 0),
    # a payload of one repeated byte also matches where it overlaps the
    # zero bytes of the pickle's length field
    "zero_frames": (lambda: _dumps([np.zeros((12, 16, 3), np.uint8)] * 3),
                    3, 0),
    # a first frame of zeros, then frames black at the bottom: the
    # zeros also match where they overlap the length field, an offset
    # the probe refuses
    "zero_then_black_bottom": (_black_bottom, 4, 0),
    # int8 among uint8 rows of one shape: only the bytes after the
    # payload (protocol 5) or before it (protocol 4) tell them apart
    "same_size_other_dtype_p4": (lambda: _int8_among_uint8(4), 2, 2),
    "same_size_other_dtype_p5": (lambda: _int8_among_uint8(5), 2, 2),
    "row_buffer_views": (lambda: _in_row_buffer(_dumps(_frames(5))), 5, 0),
    "row_buffer_views_p4": (lambda: _in_row_buffer(_dumps(_frames(5), 4)),
                            5, 0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_rows_into_matches_unpickle_and_stack(case):
    make, want_direct, want_generic = CASES[case]
    vals = make()
    rows = np.arange(len(vals))
    want = ColumnBatch.from_elements(
        rows, [decode_element(v, "pickle") for v in vals])
    made = []

    def alloc(shape, dtype):
        made.append(np.empty(shape, dtype))
        return made[-1]

    got = decode_rows_into(vals, "pickle", alloc)
    assert (got.direct, got.generic) == (want_direct, want_generic)
    assert got.direct + got.generic == sum(v is not None for v in vals)
    if isinstance(want.data, np.ndarray):
        # one batch, the one alloc gave, byte for byte the stacked rows
        assert len(made) == 1 and got.data is made[0]
        assert got.data.dtype == want.data.dtype
        assert got.data.shape == want.data.shape
        assert got.data.tobytes() == want.data.tobytes()
        np.testing.assert_array_equal(
            np.zeros(len(vals), bool) if got.nulls is None else got.nulls,
            np.zeros(len(vals), bool) if want.nulls is None else want.nulls)
        return
    batch = ColumnBatch.from_elements(rows, got.data)
    assert not isinstance(batch.data, np.ndarray)
    assert len(batch.data) == len(want.data)
    for a, b in zip(batch.data, want.data):
        if isinstance(b, np.ndarray):
            assert type(a) is np.ndarray and a.dtype == b.dtype
            assert a.shape == b.shape and a.tobytes() == b.tobytes()
        elif isinstance(b, NullElement):
            assert isinstance(a, NullElement)
        else:
            assert a == b


def test_other_codecs_decode_row_by_row():
    vals = [b"abc", None, b"de"]
    got = decode_rows_into(vals, "raw", np.empty)
    assert (got.direct, got.generic) == (0, 0)
    assert got.data[0] == b"abc" and got.data[2] == b"de"
    assert isinstance(got.data[1], NullElement)


# -- the engine on the CPU ---------------------------------------------------

N_JOB = 40


@pytest.fixture(scope="module")
def frames_db(tmp_path_factory):
    db = str(tmp_path_factory.mktemp("direct") / "db")
    frames = _RNG.integers(0, 256, (N_JOB, 18, 24, 3), dtype=np.uint8)
    sc = st.Client(db_path=db, device="cpu")
    sc.new_table("frames", ["frame"], [[f] for f in frames],
                 codecs={"frame": "pickle"})
    yield sc, db
    sc.stop()


def _histogram_job(sc, pkg, out):
    src = sc.io.Input([pkg.NamedStream(sc, "frames")])
    return sc.io.Output(sc.ops.Histogram(frame=src),
                        [pkg.NamedStream(sc, out)])


def _stored(db, table):
    desc = db.table_descriptor(table)
    return list(db.load_column(table, desc.columns[0].name))


def test_streamed_histogram_job_decodes_every_row_by_layout(frames_db):
    """A streamed Histogram job over a pickled table: every frame read is
    copied into its chunk's batch by layout, and the job stores the
    bytes the JAX package's job stores, the histograms of the frames
    the JAX package's reader gives."""
    sc, db = frames_db
    jid = sc.run(_histogram_job(sc, st, "h_port"),
                 st.PerfParams.manual(4, 16), show_progress=False,
                 cache_mode=st.CacheMode.Overwrite)
    prof, = sc.get_profile(jid).profilers
    c = prof.counters
    assert c.get("load_decode_direct", 0) == N_JOB
    assert c.get("load_decode_generic", 0) == 0
    decodes = [iv for iv in prof.intervals() if iv.name == "load:decode"]
    assert len(decodes) == N_JOB // 4     # one batch a chunk

    cj = sj.Client(db_path=db)
    try:
        cj.run(_histogram_job(cj, sj, "h_jax"),
               sj.PerfParams.manual(4, 16), show_progress=False)
        read = np.stack(list(sj.NamedStream(cj, "frames").load()))
        assert _stored(sc._db, "h_port") == _stored(cj._db, "h_jax")
    finally:
        cj.stop()
    got = np.stack(list(st.NamedStream(sc, "h_port").load()))
    np.testing.assert_array_equal(got, histogram_np(read))


# -- on the card -------------------------------------------------------------

@pytest.mark.cuda
def test_streamed_job_on_card_ships_pinned_batches(tmp_path, monkeypatch):
    """A streamed Histogram job of 20 chunks on the card: each chunk's
    rows decode into a pinned batch that stages with no copy of its own
    (no `pin_memory` call), every byte crosses to the card once, and the
    stored counts equal the plain reference's.  A pinned batch handed
    out again before its copy had finished would show in the counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the pinned staging path exists "
                    "only there; the decode itself is tested above)")
    from scanner_tpu_torch.storage import Database, PosixStorage
    n, chunk = 320, 16
    frames = np.random.default_rng(5).integers(
        0, 256, (n, 480, 640, 3), dtype=np.uint8)
    db = str(tmp_path / "db")
    Database(PosixStorage(db)).new_table(
        "frames", ["frame"], [[f] for f in frames],
        codecs={"frame": "pickle"})
    pins = []
    real_pin = torch.Tensor.pin_memory
    monkeypatch.setattr(torch.Tensor, "pin_memory",
                        lambda t, *a, **k: pins.append(t.nbytes)
                        or real_pin(t, *a, **k))
    sc = st.Client(db_path=db, device="cuda:0")
    try:
        before = _batch._M_H2D_BYTES._default.value()
        jid = sc.run(_histogram_job(sc, st, "h"),
                     st.PerfParams.manual(chunk, 4 * chunk),
                     show_progress=False)
        staged = _batch._M_H2D_BYTES._default.value() - before
        prof, = sc.get_profile(jid).profilers
        got = np.stack(list(st.NamedStream(sc, "h").load()))
    finally:
        sc.stop()
    assert prof.counters.get("load_decode_direct", 0) == n
    assert len([iv for iv in prof.intervals()
                if iv.name == "load:stage"]) == n // chunk
    assert staged == frames.nbytes
    assert pins == []
    np.testing.assert_array_equal(got, histogram_np(frames))
