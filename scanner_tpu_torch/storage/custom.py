"""Pluggable storage backends for streams: the Source/Sink extension API.

Capability parity: reference scanner/api/source.h (Source::read :69,
REGISTER_SOURCE :131), sink.h (Sink::write/finished :75-86,
REGISTER_SINK :181), enumerator.h, and the scannertools FilesStream used by
tutorial 05 (SURVEY §2.4).

A CustomStorage implements row-granular reads (source side) and item
writes (sink side); a CustomStream binds one stored stream of that storage
into a graph.  The engine treats these exactly like named-table streams —
the DAG analysis only needs `num_rows`, the loader calls `read_rows`, the
saver calls `write_item`.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Iterator, List, Optional, Sequence

from ..common import NullElement, ScannerException, StorageException
from .streams import StoredStream


class CustomStorage:
    """Extension point: subclass and implement the four methods."""

    def num_rows(self, stream: "CustomStream") -> int:
        raise NotImplementedError

    def read_rows(self, stream: "CustomStream",
                  rows: Sequence[int]) -> List[Any]:
        """Return deserialized elements for the given rows (source side)."""
        raise NotImplementedError

    def write_item(self, stream: "CustomStream", start_row: int,
                   elements: Sequence[Any]) -> None:
        """Persist rows [start_row, start_row+len) (sink side); must be
        atomic per item and idempotent (tasks may be re-executed)."""
        raise NotImplementedError

    def finished(self, stream: "CustomStream",
                 total_rows: int) -> None:
        """Durability barrier after all items of a job completed
        (reference Sink::finished, sink.h:86)."""

    def exists(self, stream: "CustomStream") -> bool:
        """Does this stream already hold data? (CacheMode enforcement.)"""
        try:
            return self.num_rows(stream) > 0
        except Exception:
            return False

    def delete_stream(self, stream: "CustomStream") -> None:
        """Remove all stored rows (CacheMode.Overwrite)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support overwrite; "
            f"delete the output manually")


class CustomStream(StoredStream):
    """A stream stored by a CustomStorage (not in the database)."""

    is_video = False
    is_custom = True

    def __init__(self, storage: CustomStorage, name: str):
        self._storage = storage
        self.name = name
        self._sc = self  # custom streams need no Database binding

    def __getstate__(self):
        d = self.__dict__.copy()
        d["_sc"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._sc = self

    def bind(self, db) -> None:  # engine rebinding is a no-op
        self._sc = self

    @property
    def storage(self) -> CustomStorage:
        return self._storage

    def len(self) -> int:
        return self._storage.num_rows(self)

    def exists(self) -> bool:
        try:
            return self.len() >= 0
        except Exception:
            return False

    def committed(self) -> bool:
        return self.exists()

    def load(self, rows: Optional[Sequence[int]] = None) -> Iterator[Any]:
        n = self.len()
        rows = list(rows) if rows is not None else list(range(n))
        for e in self._storage.read_rows(self, rows):
            yield e


class FilesStorage(CustomStorage):
    """One file per row in a directory (scannertools
    `storage.files.FilesStream` equivalent, tutorial 05).

    Rows are raw bytes by default; pass codec="pickle" for objects.
    """

    def __init__(self, root: str, ext: str = "bin", codec: str = "raw"):
        self.root = root
        self.ext = ext
        self.codec = codec

    def _dir(self, stream: CustomStream) -> str:
        return os.path.join(self.root, stream.name)

    def _path(self, stream: CustomStream, row: int) -> str:
        return os.path.join(self._dir(stream), f"{row:08d}.{self.ext}")

    def num_rows(self, stream: CustomStream) -> int:
        d = self._dir(stream)
        if not os.path.isdir(d):
            raise StorageException(f"no such file stream: {d}")
        return sum(1 for f in os.listdir(d) if f.endswith("." + self.ext))

    def read_rows(self, stream: CustomStream, rows: Sequence[int]):
        out = []
        for r in rows:
            with open(self._path(stream, r), "rb") as f:
                b = f.read()
            out.append(pickle.loads(b) if self.codec == "pickle" else b)
        return out

    def write_item(self, stream: CustomStream, start_row: int,
                   elements: Sequence[Any]) -> None:
        d = self._dir(stream)
        os.makedirs(d, exist_ok=True)
        for i, e in enumerate(elements):
            if isinstance(e, NullElement):
                raise ScannerException(
                    "FilesStorage cannot store null rows")
            b = pickle.dumps(e) if self.codec == "pickle" else bytes(e)
            p = self._path(stream, start_row + i)
            tmp = p + ".tmp"
            with open(tmp, "wb") as f:
                f.write(b)
            os.replace(tmp, p)

    def finished(self, stream: CustomStream, total_rows: int) -> None:
        d = self._dir(stream)
        if not os.path.isdir(d):
            return  # zero-row job or non-shared filesystem: nothing local
        dir_fd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)

    def exists(self, stream: CustomStream) -> bool:
        return os.path.isdir(self._dir(stream))

    def delete_stream(self, stream: CustomStream) -> None:
        import shutil
        shutil.rmtree(self._dir(stream), ignore_errors=True)


class FilesStream(CustomStream):
    def __init__(self, name: str, root: str, ext: str = "bin",
                 codec: str = "raw"):
        super().__init__(FilesStorage(root, ext=ext, codec=codec), name)
