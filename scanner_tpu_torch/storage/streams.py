"""User-facing stored stream handles.

Capability parity: reference scannerpy/storage.py — StorageBackend/
StoredStream (:19,81), NamedStorage/NamedStream (:187,250),
NamedVideoStorage/NamedVideoStream (:221,304), NullElement handling.

A stored stream is one column of one table.  NamedStream is the blob flavor,
NamedVideoStream the keyframe-indexed video flavor (decodes on load).
"""

from __future__ import annotations

import pickle
import struct
from typing import (Any, Callable, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np

from ..common import NullElement, ScannerException
from . import metadata as md
from .database import Database


# codecs whose decode copies out of the row it is given, so the row may
# be a view of a buffer that a later read reuses; decode_element hands
# a row of any other codec back as it is
DECODE_COPIES = frozenset({"pickle", "image"})


def decode_element(blob: Optional[bytes], codec: str):
    """Single source of truth for row decoding by column codec."""
    if blob is None:
        return NullElement()
    if codec == "pickle":
        return pickle.loads(blob)
    if codec == "image":
        from ..video.ingest import decode_image
        return decode_image(blob)
    return blob


class DecodedRows(NamedTuple):
    """A run of rows `decode_rows_into` decoded.  `data` is one batch
    (axis 0 = rows; null rows zero, flagged in `nulls`), or, where the
    rows are not arrays of one shape and dtype, the list of decoded
    elements for `ColumnBatch.from_elements`.  `direct` pickle rows
    were copied into the batch by their learned layout, `generic` ones
    went through `pickle.loads`."""
    data: Any
    nulls: Optional[np.ndarray]
    direct: int
    generic: int


# candidate payload offsets tried before a run's rows all take
# pickle.loads: a payload of repeated bytes also matches where it
# overlaps the pickle's own bytes
_LAYOUT_TRIES = 4


def _row_layout(blob, obj) -> Optional[Tuple[int, bytes, bytes]]:
    """Where the pickle `blob` holds the bytes of the array `obj` it
    unpickles to: (offset, prefix, suffix) such that every blob of the
    same length that starts with `prefix` and ends with `suffix`
    unpickles to an array of `obj`'s shape, dtype and order whose bytes
    are the blob's at `offset`.  Proved by unpickling a probe, the blob
    with every payload byte inverted; None where no offset passes (an
    object array, a Fortran-ordered one, a payload not stored
    verbatim)."""
    if (type(obj) is not np.ndarray or obj.dtype.hasobject
            or not obj.flags.c_contiguous or obj.nbytes == 0):
        return None
    needle = obj.reshape(-1).view(np.uint8)
    n = len(needle)
    probe = bytearray(blob)
    window = np.frombuffer(probe, np.uint8)
    last = len(probe) - n  # the last offset the payload can start at
    if last < 0:
        return None
    # offsets where the payload's first and last k bytes lie, last first
    k = min(n, 64)
    view = np.lib.stride_tricks.sliding_window_view
    starts = (view(window[:last + k], k) == needle[:k]).all(1)
    ends = (view(window[n - k:last + n], k) == needle[-k:]).all(1)
    for off in np.flatnonzero(starts & ends)[::-1][:_LAYOUT_TRIES]:
        np.invert(needle, out=window[off:off + n])
        try:
            got = pickle.loads(probe)
        except Exception:  # noqa: BLE001 — the probe broke the pickle
            got = None
        if (type(got) is np.ndarray and got.shape == obj.shape
                and got.dtype == obj.dtype and got.flags.c_contiguous
                and probe[off:off + n]
                == got.reshape(-1).view(np.uint8).data):
            # the probe's prefix and suffix are the blob's own
            return int(off), bytes(probe[:off]), bytes(probe[off + n:])
        window[off:off + n] = needle
    return None


def decode_rows_into(vals: Sequence[Optional[Any]], codec: str,
                     alloc: Callable[[tuple, np.dtype], np.ndarray]
                     ) -> DecodedRows:
    """Decode a run of stored rows (bytes or views, None for a null
    row) into one batch that `alloc(shape, dtype)` gives.

    For the `pickle` codec the run's first live row is unpickled and, if
    it is a C-contiguous array, its layout learned (`_row_layout`): every
    row of the same length, prefix and suffix then decodes to the same
    shape, dtype and order, so its payload is copied into its slot with
    one numpy copy, no Python object made.  A row that does not match is
    unpickled and assigned into its slot if its shape and dtype are the
    batch's; a row of another shape, or anything not an array, sends the
    run to the element list, as `ColumnBatch.from_elements` takes it.
    Other codecs decode row by row (`decode_element`) into the list."""
    if codec != "pickle":
        return DecodedRows([decode_element(v, codec) for v in vals],
                           None, 0, 0)
    live = [i for i, v in enumerate(vals) if v is not None]
    if not live:
        return DecodedRows([NullElement()] * len(vals), None, 0, 0)
    first = pickle.loads(vals[live[0]])
    if type(first) is not np.ndarray or first.dtype.hasobject:
        elems: List[Any] = [NullElement()] * len(vals)
        elems[live[0]] = first
        for i in live[1:]:
            elems[i] = pickle.loads(vals[i])
        return DecodedRows(elems, None, 0, len(live))
    out = alloc((len(vals),) + first.shape, first.dtype)
    layout = _row_layout(vals[live[0]], first)
    if layout is not None:
        off, prefix, suffix = layout
        rows = out.reshape(len(vals), -1).view(np.uint8)
        tail = off + rows.shape[1]
        size = tail + len(suffix)
    nulls = np.zeros(len(vals), bool)
    direct = generic = 0
    for i, v in enumerate(vals):
        if v is None:
            nulls[i] = True
            out[i] = 0
            continue
        if (layout is not None and len(v) == size
                and v[:off] == prefix and v[tail:] == suffix):
            rows[i] = np.frombuffer(v, np.uint8, rows.shape[1], off)
            direct += 1
            continue
        obj = first if i == live[0] else pickle.loads(v)
        generic += 1
        if (isinstance(obj, np.ndarray) and obj.shape == first.shape
                and obj.dtype == first.dtype):
            out[i] = obj
            continue
        # not one batch: the rows so far as elements, then the rest
        elems = [NullElement() if nulls[j] else out[j].copy()
                 for j in range(i)] + [obj]
        for rest in vals[i + 1:]:
            elems.append(decode_element(rest, codec))
            generic += rest is not None
        return DecodedRows(elems, None, direct, generic)
    return DecodedRows(out, nulls if nulls.any() else None, direct, generic)


class StoredStream:
    """Base: a named, typed, committed-or-not stream of rows."""

    is_video = False

    def __init__(self, sc, name: str):
        # sc is a Client or anything exposing ._db (a Database)
        self._sc = sc
        self.name = name

    @property
    def db(self) -> Database:
        if self._sc is None:
            raise ScannerException(
                f"stream {self.name} is unbound; it traveled over RPC and "
                f"must be re-bound to a Database first")
        return self._sc._db if hasattr(self._sc, "_db") else self._sc

    def bind(self, db: Database) -> None:
        self._sc = db

    def __getstate__(self) -> dict:
        # streams travel to the master/workers inside cloudpickled graphs;
        # the Client (grpc channels etc.) must not come along
        d = self.__dict__.copy()
        d["_sc"] = None
        return d

    # -- engine-facing ------------------------------------------------------

    @property
    def column(self) -> str:
        return "output"

    def exists(self) -> bool:
        return self.db.has_table(self.name)

    def committed(self) -> bool:
        return self.db.table_is_committed(self.name)

    def len(self) -> int:
        return self.db.table_descriptor(self.name).num_rows

    def __len__(self) -> int:
        return self.len()

    def delete(self) -> None:
        self.db.delete_table(self.name)

    # -- reading ------------------------------------------------------------

    def load_bytes(self, rows: Optional[Sequence[int]] = None
                   ) -> Iterator[Optional[bytes]]:
        desc = self.db.table_descriptor(self.name)
        col = self.column if self.column in desc.column_names() \
            else next(c for c in desc.column_names() if c != "index")
        yield from self.db.load_column(self.name, col, rows=rows)

    def load(self, rows: Optional[Sequence[int]] = None,
             column: Optional[str] = None) -> Iterator[Any]:
        """Deserialize rows (reference StoredStream.load, storage.py:135).

        Dispatches on the stored column type, so a NamedStream bound to a
        frame column an engine job wrote in video mode decodes correctly
        (the items under it are H.264 packet runs, not blob rows)."""
        desc = self.db.table_descriptor(self.name)
        col = column or (
            self.column if self.column in desc.column_names()
            else next(c for c in desc.column_names() if c != "index"))
        if desc.column_type(col) == md.ColumnType.VIDEO:
            from ..video.ingest import iter_frames
            if rows is None:
                rows = range(desc.num_rows)
            yield from iter_frames(self.db, self.name, list(rows), col)
            return
        codec = None
        for c in desc.columns:
            if c.name == col:
                codec = getattr(c, "codec", "pickle")
        for blob in self.db.load_column(self.name, col, rows=rows):
            yield decode_element(blob, codec or "raw")


class NamedStream(StoredStream):
    """Blob stream stored in a named table (reference NamedStream)."""


class NamedVideoStream(StoredStream):
    """Keyframe-indexed video stream (reference NamedVideoStream:304).

    With `path=`, the video is ingested lazily at first use
    (reference storage.py:235 auto-ingest).
    """

    is_video = True

    def __init__(self, sc, name: str, path: Optional[str] = None,
                 inplace: bool = False):
        super().__init__(sc, name)
        self._path = path
        self._inplace = inplace

    @property
    def column(self) -> str:
        return "frame"

    def ensure_ingested(self) -> None:
        if self._path is not None and not self.exists():
            from ..common import ScannerException
            from ..video import ingest_videos
            _, failed = ingest_videos(self.db, [(self.name, self._path)],
                                      inplace=self._inplace)
            if failed:
                # single-stream auto-ingest: a failure here IS fatal
                raise ScannerException(
                    f"ingest of {failed[0][0]} failed: {failed[0][1]}")

    def len(self) -> int:
        self.ensure_ingested()
        return super().len()

    def estimate_size(self) -> int:
        return self.estimate_geometry()[0]

    def estimate_keyint(self) -> int:
        """Typical keyframe spacing in DISPLAY frames (0 = unknown).
        PerfParams.estimate aligns io packets to this so task boundaries
        land on keyframes and consecutive tasks never re-decode a GOP
        prefix."""
        return self.estimate_geometry()[1]

    def estimate_geometry(self) -> tuple:
        """(frame_bytes, keyint) from ONE descriptor read — the estimate
        loop runs over every stream of every job at launch, so metadata
        I/O here is per-corpus, not per-call."""
        self.ensure_ingested()
        vd = self._video_meta()
        frame_bytes = int(vd.width * vd.height * 3)
        kfs = np.asarray(vd.keyframe_indices)
        if len(kfs) < 2:
            return frame_bytes, 0
        # decode->display: keyframe display positions are the pts ranks
        pts = np.asarray(vd.sample_pts, np.int64)
        disp_of_dec = np.empty(len(pts), np.int64)
        disp_of_dec[np.argsort(pts, kind="stable")] = np.arange(len(pts))
        gaps = np.diff(np.sort(disp_of_dec[kfs]))
        keyint = int(np.median(gaps)) if len(gaps) else 0
        return frame_bytes, keyint

    def _video_meta(self) -> md.VideoDescriptor:
        from ..video import load_video_meta
        return load_video_meta(self.db, self.name, self.column)

    def load(self, rows: Optional[Sequence[int]] = None) -> Iterator[Any]:
        """Decode frames (reference NamedVideoStream.load via hwang);
        the column-type dispatch lives in StoredStream.load."""
        self.ensure_ingested()
        yield from super().load(rows=rows)

    def save_mp4(self, path: str) -> None:
        from ..video import export_mp4
        export_mp4(self.db, self.name, path, self.column)

    def as_hwang(self):  # pragma: no cover - reference-compat shim
        raise ScannerException(
            "as_hwang is CUDA-reference-specific; use load() instead")
