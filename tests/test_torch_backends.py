"""Storage back ends (util/retry.py, storage/gcs.py, storage/custom.py):
the JAX package and the port on the same seeded inputs.  Retry delays
and budgets must be the same numbers; the GCS backend runs against an
in-memory fake of the google-cloud-storage client surface (a copy of
tests/test_gcs.py's fake, no network) and must leave the same object
names and bytes for the same table; a FilesStream source and sink must
give the same rows."""

import os
import random
import struct
import threading

import numpy as np
import pytest

import scanner_tpu as sj
import scanner_tpu.kernels  # noqa: F401
from scanner_tpu.storage import Database as JDatabase
from scanner_tpu.storage import FilesStream as JFilesStream
from scanner_tpu.storage import GcsStorage as JGcs
from scanner_tpu.util import retry as jretry

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.common import StorageException
from scanner_tpu_torch.storage import Database as TDatabase
from scanner_tpu_torch.storage import FilesStream as TFilesStream
from scanner_tpu_torch.storage import GcsStorage as TGcs
from scanner_tpu_torch.storage import make_storage, parse_gs_url
from scanner_tpu_torch.storage.metadata import unpack
from scanner_tpu_torch.util import retry as tretry
from torch_model_checks import stop_process_engine  # noqa: F401


# -- an in-memory google-cloud-storage client (tests/test_gcs.py's) ----------

class _ApiError(Exception):
    def __init__(self, code):
        super().__init__(f"http {code}")
        self.code = code


class FakeBlob:
    def __init__(self, store, lock, name):
        self._store, self._lock, self.name = store, lock, name
        self.chunk_size = None

    @property
    def size(self):
        with self._lock:
            if self.name not in self._store:
                return None
            return len(self._store[self.name])

    def upload_from_string(self, data, content_type=None,
                           if_generation_match=None):
        with self._lock:
            if if_generation_match == 0 and self.name in self._store:
                raise _ApiError(412)
            self._store[self.name] = bytes(data)

    def download_as_bytes(self, start=None, end=None):
        with self._lock:
            if self.name not in self._store:
                raise _ApiError(404)
            data = self._store[self.name]
        if start is None:
            return data
        if start >= len(data):
            raise _ApiError(416)
        return data[start:(end + 1) if end is not None else None]

    def exists(self):
        with self._lock:
            return self.name in self._store

    def delete(self):
        with self._lock:
            if self.name not in self._store:
                raise _ApiError(404)
            del self._store[self.name]


class FakeBucket:
    def __init__(self, store, lock, name):
        self._store, self._lock, self.name = store, lock, name

    def blob(self, key):
        return FakeBlob(self._store, self._lock, key)

    def get_blob(self, key):
        with self._lock:
            if key not in self._store:
                return None
        return FakeBlob(self._store, self._lock, key)


class FakeGcsClient:
    def __init__(self):
        self._store = {}
        self._lock = threading.Lock()

    def bucket(self, name):
        return FakeBucket(self._store, self._lock, name)

    def list_blobs(self, bucket, prefix=""):
        with self._lock:
            names = sorted(k for k in self._store if k.startswith(prefix))
        return [FakeBlob(self._store, self._lock, n) for n in names]


# -- util/retry.py -----------------------------------------------------------

@pytest.mark.parametrize("seed,base,cap", [(0, 0.05, 2.0), (7, 0.25, 1.0),
                                           (123, 0.01, 0.1)])
def test_backoff_delays_equal_under_one_seed(seed, base, cap):
    want = list(jretry.backoff_delays(12, base=base, cap=cap,
                                      rng=random.Random(seed)))
    got = list(tretry.backoff_delays(12, base=base, cap=cap,
                                     rng=random.Random(seed)))
    assert got == want
    assert all(0.0 <= d <= min(cap, base * 2 ** i)
               for i, d in enumerate(got))


def _flaky(fails, exc=ConnectionError):
    calls = [0]

    def fn():
        calls[0] += 1
        if calls[0] <= fails:
            raise exc(f"flap {calls[0]}")
        return calls[0]
    return fn, calls


@pytest.mark.parametrize("fails,retries", [(0, 4), (3, 4), (5, 4)])
def test_call_with_backoff_same_sleeps_and_outcome(fails, retries):
    """Same attempts, same sleeps (seeded), same give-up, each package
    on a private budget."""
    out = {}
    for name, mod in (("jax", jretry), ("torch", tretry)):
        fn, calls = _flaky(fails)
        slept = []
        try:
            res = mod.call_with_backoff(
                fn, is_transient=lambda e: isinstance(e, ConnectionError),
                retries=retries, sleep=slept.append,
                rng=random.Random(3), budget=mod.RetryBudget())
        except ConnectionError as e:
            res = f"raised {e}"
        out[name] = (res, calls[0], slept)
    assert out["torch"] == out["jax"]


def test_non_transient_propagates_without_retry():
    for mod in (jretry, tretry):
        fn, calls = _flaky(1, exc=ValueError)
        with pytest.raises(ValueError):
            mod.call_with_backoff(
                fn, is_transient=lambda e: isinstance(e, ConnectionError),
                sleep=lambda s: None, budget=mod.RetryBudget())
        assert calls[0] == 1


def test_retry_budget_semantics_equal():
    """Withdraw until the half-capacity floor, then fail fast; successes
    deposit token_ratio back, capped at capacity."""
    trace = {}
    for name, mod in (("jax", jretry), ("torch", tretry)):
        b = mod.RetryBudget(max_tokens=10.0, token_ratio=0.5)
        steps = [b.take() for _ in range(7)]
        for _ in range(3):
            b.on_success()
        steps.append(b.tokens())
        steps += [b.take() for _ in range(3)]
        for _ in range(40):
            b.on_success()
        steps.append(b.tokens())
        b.reset()
        steps.append(b.tokens())
        trace[name] = steps
    assert trace["torch"] == trace["jax"]
    assert trace["torch"][:7] == [True] * 5 + [False, False]
    assert isinstance(tretry.process_budget(), tretry.RetryBudget)


def test_retry_until_deadline_same_sleeps():
    import time
    out = {}
    for name, mod in (("jax", jretry), ("torch", tretry)):
        fn, calls = _flaky(4)
        slept = []
        res = mod.retry_until_deadline(
            fn, is_transient=lambda e: isinstance(e, ConnectionError),
            deadline=time.time() + 60.0, sleep=slept.append,
            rng=random.Random(11), budget=mod.RetryBudget())
        out[name] = (res, calls[0], slept)
    assert out["torch"] == out["jax"]


# -- storage/gcs.py ----------------------------------------------------------

@pytest.fixture()
def gcs():
    return TGcs("bkt", "db", client=FakeGcsClient())


def test_parse_gs_url():
    assert parse_gs_url("gs://bkt/a/b/") == ("bkt", "a/b")
    assert parse_gs_url("gs://bkt") == ("bkt", "")
    with pytest.raises(StorageException):
        parse_gs_url("/local/path")
    with pytest.raises(StorageException):
        parse_gs_url("gs://")


def test_gcs_roundtrip_and_ranged_reads(gcs):
    gcs.write("a/b.bin", b"hello world")
    assert gcs.read("a/b.bin") == b"hello world"
    assert gcs.read_range("a/b.bin", 6, 5) == b"world"
    assert gcs.read_range("a/b.bin", 6, 100) == b"world"  # clipped at EOF
    assert gcs.read_range("a/b.bin", 100, 5) == b""       # past EOF
    assert gcs.exists("a/b.bin")
    assert gcs.size("a/b.bin") == 11
    with pytest.raises(StorageException):
        gcs.read("missing")
    with pytest.raises(StorageException):
        gcs.size("missing")


def test_gcs_write_exclusive_first_writer_wins(gcs):
    assert gcs.write_exclusive("m", b"video") is True
    assert gcs.write_exclusive("m", b"pickle") is False
    assert gcs.read("m") == b"video"


def test_gcs_delete_listing_and_prefix_boundary(gcs):
    for i in range(3):
        gcs.write(f"t/{i}.bin", bytes([i]))
    gcs.write("other.bin", b"x")
    assert gcs.list_prefix("t") == ["t/0.bin", "t/1.bin", "t/2.bin"]
    gcs.delete("t/1.bin")
    gcs.delete("t/1.bin")  # idempotent
    assert gcs.list_prefix("t") == ["t/0.bin", "t/2.bin"]
    gcs.delete_prefix("t")
    assert gcs.list_prefix("t") == []
    assert gcs.exists("other.bin")
    # deleting table 5's prefix must not touch table 52
    gcs.write("tables/5/output_0.bin", b"five")
    gcs.write("tables/52/output_0.bin", b"fifty-two")
    assert gcs.list_prefix("tables/5") == ["tables/5/output_0.bin"]
    gcs.delete_prefix("tables/5")
    assert gcs.exists("tables/52/output_0.bin")


def test_make_storage_gcs():
    fake = FakeGcsClient()
    s = make_storage("gcs", db_path="gs://bkt/pre", client=fake)
    assert isinstance(s, TGcs)
    s.write("x", b"1")
    assert fake._store == {"pre/x": b"1"}
    s2 = make_storage("gcs", bucket="bkt", prefix="p2", client=fake)
    s2.write("y", b"2")
    assert fake._store["p2/y"] == b"2"
    with pytest.raises(StorageException):
        make_storage("gcs")


def _untimed(obj):
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items() if k != "timestamp"}
    if isinstance(obj, (list, tuple)):
        return [_untimed(v) for v in obj]
    return obj


def test_gcs_table_same_objects_as_jax():
    """One table written through each package's GCS backend: the same
    object names and the same bytes; each package reads the other's."""
    rng = np.random.RandomState(5)
    rows = [[rng.bytes(int(rng.randint(1, 64))), rng.bytes(3)]
            for _ in range(9)]
    fj, ft = FakeGcsClient(), FakeGcsClient()
    jdb = JDatabase(JGcs("bkt", "db", client=fj))
    tdb = TDatabase(TGcs("bkt", "db", client=ft))
    jdb.new_table("t", ["a", "b"], rows)
    tdb.new_table("t", ["a", "b"], rows)
    jdb.write_megafile()
    tdb.write_megafile()
    assert sorted(ft._store) == sorted(fj._store)
    # the row items byte for byte; the metadata objects apart from the
    # creation timestamps they carry
    for name, blob in fj._store.items():
        if name.endswith(("descriptor.bin", "megafile.bin")):
            assert _untimed(unpack(ft._store[name])) == \
                _untimed(unpack(blob)), name
        else:
            assert ft._store[name] == blob, name
    cross = TDatabase(TGcs("bkt", "db", client=fj))
    cross.load_megafile()
    assert list(cross.load_column("t", "b")) == [r[1] for r in rows]


def test_client_on_gs_path_runs_a_job():
    """Client(db_path="gs://...") runs a job on the fake bucket: the
    Histogram rows equal the JAX package's on its own fake bucket."""
    rng = np.random.RandomState(1)
    frames = rng.randint(0, 256, (10, 12, 16, 3)).astype(np.uint8)
    ft = FakeGcsClient()
    ct = st.Client(db_path="gs://bkt/db", device="cpu",
                   storage_options={"client": ft})
    ct.new_table("frames", ["frame"], [[f] for f in frames],
                 codecs={"frame": "pickle"})
    src = ct.io.Input([st.NamedStream(ct, "frames")])
    ct.run(ct.io.Output(ct.ops.Histogram(frame=src),
                        [st.NamedStream(ct, "h")]),
           st.PerfParams.manual(4, 8), show_progress=False)
    got = list(st.NamedStream(ct, "h").load())
    # the JAX package reads the same bucket's frames table and bins it
    cj = sj.Client(db_path="gs://bkt/db", storage_options={"client": ft})
    src = cj.io.Input([sj.NamedStream(cj, "frames")])
    cj.run(cj.io.Output(cj.ops.Histogram(frame=src),
                        [sj.NamedStream(cj, "hj")]),
           sj.PerfParams.manual(4, 8), show_progress=False)
    want = list(sj.NamedStream(cj, "hj").load())
    assert len(got) == len(want) == 10
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    ct.stop()
    cj.stop()


# -- storage/custom.py -------------------------------------------------------

@st.register_op(name="TorchTestTripleUp")
class _TripleUpT(st.Kernel):
    def execute(self, x: bytes) -> bytes:
        (v,) = struct.unpack("<q", x)
        return struct.pack("<q", 3 * v + 1)


@sj.register_op(name="TorchTestTripleUp")
class _TripleUpJ(sj.Kernel):
    def execute(self, x: bytes) -> bytes:
        (v,) = struct.unpack("<q", x)
        return struct.pack("<q", 3 * v + 1)


def test_files_storage_rows_equal(tmp_path):
    """FilesStream sources through ops into FilesStream sinks: raw rows
    through TripleUp, and pickled frames through Histogram into a
    pickled sink — the same files and rows in both packages; CacheMode
    applies to a custom sink."""
    import pickle
    rng = np.random.RandomState(9)
    vals = rng.randint(-1000, 1000, 13)
    frames = rng.randint(0, 256, (7, 8, 10, 3)).astype(np.uint8)
    src_root = str(tmp_path / "files_in")
    for name in ("nums", "frames"):
        os.makedirs(os.path.join(src_root, name))
    for i, v in enumerate(vals):
        with open(os.path.join(src_root, "nums", f"{i:08d}.bin"),
                  "wb") as f:
            f.write(struct.pack("<q", int(v)))
    for i, fr in enumerate(frames):
        with open(os.path.join(src_root, "frames", f"{i:08d}.bin"),
                  "wb") as f:
            f.write(pickle.dumps(fr))
    out = {}
    for name, pkg, fs in (("jax", sj, JFilesStream),
                          ("torch", st, TFilesStream)):
        kw = {} if pkg is sj else {"device": "cpu"}
        sc = pkg.Client(db_path=str(tmp_path / f"db_{name}"), **kw)
        src = fs("nums", src_root)
        assert src.len() == len(vals)
        dst = fs("nums_out", str(tmp_path / f"out_{name}"))

        def graph():
            return sc.io.Output(
                sc.ops.TorchTestTripleUp(x=sc.io.Input([src])), [dst])
        sc.run(graph(), pkg.PerfParams.manual(4, 4), show_progress=False)
        with pytest.raises(pkg.JobException):
            sc.run(graph(), pkg.PerfParams.manual(4, 4),
                   show_progress=False)
        hists = fs("hists", str(tmp_path / f"out_{name}"), codec="pickle")
        col = sc.io.Input([fs("frames", src_root, codec="pickle")])
        sc.run(sc.io.Output(sc.ops.Histogram(frame=col), [hists]),
               pkg.PerfParams.manual(4, 4), show_progress=False)
        out[name] = (list(dst.load()), list(hists.load()))
        sc.stop()
    assert out["torch"][0] == out["jax"][0]
    assert [struct.unpack("<q", b)[0] for b in out["torch"][0]] == \
        [3 * int(v) + 1 for v in vals]
    assert len(out["torch"][1]) == len(out["jax"][1]) == len(frames)
    for g, w in zip(*(out[k][1] for k in ("torch", "jax"))):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
