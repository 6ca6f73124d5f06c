"""Stored rows read into a buffer the reader keeps
(`storage/items.py` `read_item_rows_into`, `Database.read_rows_into`):
the same rows as the JAX package's `read_item_rows` on the same item
files, at most 2 + (runs of adjacent requested rows) backend reads a
call, the `storage.read` fault site on the new path, and jobs whose
loader reads through one kept buffer chunk after chunk.
"""

import pickle

import numpy as np
import pytest

from scanner_tpu.storage import Database as JDatabase
from scanner_tpu.storage import items as jitems
from scanner_tpu.storage import metadata as jmd
from scanner_tpu.storage.backend import PosixStorage as JPosix

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.common import NullElement, StorageException
from scanner_tpu_torch.storage import Database
from scanner_tpu_torch.storage import items
from scanner_tpu_torch.storage import metadata as md
from scanner_tpu_torch.storage.backend import MemoryStorage, PosixStorage
from scanner_tpu_torch.util import faults
from torch_model_checks import stop_process_engine  # noqa: F401

# nrows -> rows; every 7th row (3, 10, ...) null, sizes 0..40 bytes
NROWS = 400
# more rows than the sizes of SIZES_PREFIX hold
NROWS_BIG = (items.SIZES_PREFIX - items.HEADER_MAX) // 8 + 300


def _rows(n, seed=0):
    rng = np.random.RandomState(seed)
    return [NullElement() if i % 7 == 3
            else rng.bytes(int(rng.randint(0, 41))) for i in range(n)]


def _runs(local):
    want = sorted(set(local))
    return 1 + sum(1 for a, b in zip(want, want[1:]) if b != a + 1)


def _plain(vals):
    return [None if v is None else bytes(v) for v in vals]


REQUESTS = {
    "one_run": [40, 41, 42, 43, 44],
    "scattered": [5, 90, 200, 333, 399],
    "unsorted": [44, 12, 13, 300, 11, 0],
    "duplicates": [8, 8, 9, 8, 250, 250],
    "nulls": [3, 10, 17, 24, 4, 5],
    "all_null": [3, 10],
    "many_runs": list(range(0, 48, 2)),
    "dense": list(range(0, 400, 5)),
}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """One directory of item files written by the port, read by both
    packages' POSIX backends."""
    root = str(tmp_path_factory.mktemp("row_reads"))
    back = PosixStorage(root)
    items.write_item(back, "t/small", _rows(NROWS))
    items.write_item(back, "t/big", _rows(NROWS_BIG, seed=1))
    return root, back, JPosix(root)


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_rows_equal_the_jax_reader(stores, case):
    _, back, jback = stores
    local = REQUESTS[case]
    buf = items.RowBuffer()
    got = items.read_item_rows_into(back, "t/small", local, buf)
    assert _plain(got) == jitems.read_item_rows(jback, "t/small", local)
    if case != "dense":
        # the rows are views of the buffer, not bytes of their own
        assert all(isinstance(v, memoryview) for v in got if v is not None)
    # the bytes reader is the same read with a buffer of its own
    assert items.read_item_rows(back, "t/small", local) == _plain(got)


@pytest.mark.parametrize("local", [[7, 4100, 4101, 4102, 6],
                                   [NROWS_BIG - 1, 0]],
                         ids=["runs", "ends"])
def test_a_header_past_the_prefix_takes_one_more_read(stores, local):
    _, back, jback = stores
    counted = _Counting(back)
    got = items.read_item_rows_into(counted, "t/big", local,
                                    items.RowBuffer())
    assert _plain(got) == jitems.read_item_rows(jback, "t/big", local)
    assert counted.range_reads == 2


def test_successive_reads_reuse_the_buffer_and_keep_their_rows(stores):
    """The buffer grows only for a larger read; a read's views stay
    right until the next read starts."""
    _, back, jback = stores
    buf = items.RowBuffer()
    seen = []
    for local in ([40, 41, 42], [100, 101], [7, 8], list(range(200, 240))):
        buf.start()
        got = items.read_item_rows_into(back, "t/small", local, buf)
        seen.append(buf.grew)
        assert _plain(got) == jitems.read_item_rows(jback, "t/small",
                                                    local)
    assert seen == [True, False, False, True]


@pytest.mark.parametrize("rows", [[-1], [NROWS], [5, NROWS + 3, 6]])
def test_rows_out_of_bounds_raise(stores, rows):
    _, back, _ = stores
    with pytest.raises(StorageException, match="out of item bounds"):
        items.read_item_rows_into(back, "t/small", rows, items.RowBuffer())


class _Counting:
    """A backend wrapper that counts the reads it passes on; the base
    class's read_into (read_range and a copy) serves backends without
    their own."""

    def __init__(self, inner):
        self.inner = inner
        self.range_reads = self.into_reads = self.whole_reads = 0

    def read(self, path):
        self.whole_reads += 1
        return self.inner.read(path)

    def read_range(self, path, offset, size):
        self.range_reads += 1
        return self.inner.read_range(path, offset, size)

    def read_into(self, path, offset, view):
        self.into_reads += 1
        return self.inner.read_into(path, offset, view)

    @property
    def total(self):
        return self.range_reads + self.into_reads + self.whole_reads


@pytest.mark.parametrize("kind", ["posix", "memory"])
@pytest.mark.parametrize("case", sorted(set(REQUESTS) - {"dense"}))
def test_at_most_two_plus_one_read_a_run(tmp_path, kind, case):
    back = PosixStorage(str(tmp_path)) if kind == "posix" \
        else MemoryStorage()
    rows = _rows(NROWS)
    items.write_item(back, "t/small", rows)
    counted = _Counting(back)
    local = REQUESTS[case]
    buf = items.RowBuffer()
    got = items.read_item_rows_into(counted, "t/small", local, buf)
    assert _plain(got) == [None if isinstance(rows[r], NullElement)
                           else rows[r] for r in local]
    assert counted.total <= 2 + _runs(local)
    assert counted.range_reads == 1 and counted.whole_reads == 0
    assert buf.reads == counted.total


@pytest.mark.parametrize("kind", ["posix", "memory"])
def test_the_read_fault_site_fires_on_the_new_path(tmp_path, kind):
    back = PosixStorage(str(tmp_path)) if kind == "posix" \
        else MemoryStorage()
    # row 4 holds the middle of the prefix read and of the whole item
    # (MemoryStorage corrupts the item, then takes the range), so a
    # corrupted prefix leaves the header and the sizes as they were
    rows = [bytes([i]) * (2 * items.SIZES_PREFIX if i == 4 else 64)
            for i in range(40)]
    items.write_item(back, "tables/1/item", rows)
    try:
        faults.install("storage.read:raise:exc=storage:msg=injected")
        with pytest.raises(StorageException, match="injected"):
            items.read_item_rows_into(back, "tables/1/item", [4],
                                      items.RowBuffer())
        faults.clear()
        faults.install("storage.read:corrupt")
        got = items.read_item_rows_into(back, "tables/1/item", [4],
                                        items.RowBuffer())
        assert faults.fired("storage.read") == 2
    finally:
        faults.clear()
    row = bytes(got[0])
    assert row != rows[4] and len(row) == len(rows[4])
    assert sum(a != b for a, b in zip(row, rows[4])) == 1


def test_a_table_of_several_items_reads_as_the_jax_database(tmp_path):
    """Rows of one request that fall into several items of a column
    share the buffer, in request order."""
    db = Database(PosixStorage(str(tmp_path)))
    col = md.ColumnDescriptor("blob", md.ColumnType.BYTES)
    per_item = [_rows(NROWS, seed=s) for s in range(3)]
    desc = db.create_table("multi", [col],
                           end_rows=[NROWS, 2 * NROWS, 3 * NROWS],
                           commit=True)
    for i, rows in enumerate(per_item):
        items.write_item(db.backend, md.column_item_path(desc.id, "blob", i),
                         rows)
    jdb = JDatabase(JPosix(str(tmp_path)))
    assert jmd.column_item_path(desc.id, "blob", 2) == \
        md.column_item_path(desc.id, "blob", 2)
    want_rows = [850, 5, 6, 7, 401, 400, 3, 1199, 6, 10]
    buf = items.RowBuffer()
    got = db.read_rows_into("multi", "blob", want_rows, buf)
    assert _plain(got) == list(jdb.load_column("multi", "blob",
                                               rows=want_rows))
    # three prefixes, then a read a run that holds bytes: {5, 6, 7} of
    # the first item (3 and 10 are null), {400, 401}, {850} and {1199}
    assert buf.reads == 3 + 1 + 1 + 2
    with pytest.raises(StorageException, match="no column"):
        db.read_rows_into("multi", "nope", [1], buf)


# -- jobs whose loader reads through one kept buffer ----------------------

N_JOB = 64          # rows a table; 4-row chunks stay on the sparse path


@st.register_op(name="TorchTestRowEcho")
def _row_echo(config, frame: bytes, blob: bytes) -> bytes:
    return pickle.dumps((np.asarray(frame), bytes(blob)),
                        protocol=pickle.HIGHEST_PROTOCOL)


@pytest.fixture(scope="module")
def client(tmp_path_factory):
    sc = st.Client(db_path=str(tmp_path_factory.mktemp("echo") / "db"),
                   device="cpu")
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (N_JOB, 6, 5, 3), dtype=np.uint8)
    blobs = [rng.bytes(int(n)) for n in rng.integers(1, 300, N_JOB)]
    sc.new_table("pk", ["frame"], [[f] for f in frames],
                 codecs={"frame": "pickle"})
    sc.new_table("rw", ["blob"], [[b] for b in blobs])
    yield sc, frames, blobs
    sc.stop()


@pytest.fixture(scope="module", params=["threads", "serial"])
def echo_job(request, client):
    sc, frames, blobs = client
    mp = pytest.MonkeyPatch()
    if request.param == "serial":
        mp.setenv("SCANNER_TPU_NO_PIPELINING", "1")
    out = f"echo_{request.param}"
    frame = sc.io.Input([st.NamedStream(sc, "pk")])
    blob = sc.io.Input([st.NamedStream(sc, "rw")])
    graph = sc.io.Output(sc.ops.TorchTestRowEcho(frame=frame, blob=blob),
                         [st.NamedStream(sc, out)])
    try:
        jid = sc.run(graph, st.PerfParams.manual(4, 32),
                     show_progress=False, cache_mode=st.CacheMode.Overwrite)
    finally:
        mp.undo()
    prof, = sc.get_profile(jid).profilers
    return sc, out, prof, frames, blobs


def test_a_streamed_job_stores_every_row_as_read(echo_job):
    """A pickle column and a raw column read chunk after chunk by one
    loader: had a batch kept a view of the buffer, a later chunk's read
    would have overwritten its rows."""
    sc, out, _, frames, blobs = echo_job
    desc = sc._db.table_descriptor(out)
    got = list(sc._db.load_column(out, desc.columns[0].name))
    assert len(got) == N_JOB
    for i, row in enumerate(got):
        f, b = pickle.loads(row)
        np.testing.assert_array_equal(f, frames[i])
        assert b == blobs[i]


def test_kept_and_fresh_count_every_column_read(echo_job):
    _, _, prof, _, _ = echo_job
    reads = [iv for iv in prof.intervals() if iv.name == "load:read"]
    c = prof.counters
    kept, fresh = c.get("load_read_kept", 0), c.get("load_read_fresh", 0)
    # two columns, 4-row chunks of 64 rows: 32 column reads
    assert len(reads) == 2 * N_JOB // 4
    assert kept + fresh == len(reads)
    # a loader's buffer grows at most at its first read of each column;
    # every later chunk fits in it
    loaders = {iv.thread for iv in reads}
    assert 1 <= fresh <= 2 * len(loaders)
    # a prefix and one run a chunk
    assert all(iv.args["reads"] == 2 for iv in reads)
    assert all(iv.args["bytes"] > 0 for iv in reads)

