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
from typing import Any, Iterator, List, Optional, Sequence

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
