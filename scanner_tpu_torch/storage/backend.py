"""Storage backends.

Capability parity: the reference delegates persistence to the external
`storehouse` library (POSIX/GCS/S3 — reference scanner/util/storehouse.h,
python config.py:56).  Here the same narrow interface is defined natively;
POSIX is the production backend (works against local disk, NFS and
GCS-via-gcsfuse), Memory backs unit tests.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterator, List, Optional

from ..common import StorageException
from ..util import faults as _faults


class StorageBackend:
    """A flat blob store keyed by slash-separated paths.

    Writes are atomic (visible entirely or not at all) so that concurrent
    readers — other workers, the master — never observe torn metadata.
    """

    def read(self, path: str) -> bytes:
        raise NotImplementedError

    def read_range(self, path: str, offset: int, size: int) -> bytes:
        raise NotImplementedError

    def read_into(self, path: str, offset: int, view: memoryview) -> None:
        """Fill the writable `view` with the `len(view)` bytes of `path`
        at `offset`; a range past the end raises.  This default copies
        out of `read_range`, so any backend serves it; one that can
        read straight into caller memory overrides it."""
        data = self.read_range(path, offset, len(view))
        if len(data) != len(view):
            raise StorageException(
                f"short read ({len(data)} of {len(view)} bytes at "
                f"{offset}): {path}")
        view[:] = data

    def write(self, path: str, data: bytes, sync: bool = True) -> None:
        """Atomically replace `path` with `data`.  sync=False skips the
        durability barrier (fsync) where the backend has one: the blob
        still survives a PROCESS kill (the page cache outlives it) but
        not a machine crash — the right trade for the master's
        write-ahead journal segments, whose format tolerates a torn
        tail and which would otherwise pay one fsync per acknowledged
        task completion."""
        raise NotImplementedError

    def write_exclusive(self, path: str, data: bytes) -> bool:
        """Create `path` with `data` only if it does not exist.

        Returns True when this call created the blob, False when it already
        existed (data untouched).  Used for cross-worker arbitration
        markers (first writer wins); backends should override with a
        truly atomic variant.  This default is a best-effort
        exists/write sequence — racy across processes, but it keeps
        pre-existing third-party backends working at save time.
        """
        if self.exists(path):
            return False
        self.write(path, data)
        return True

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def size(self, path: str) -> int:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def delete_prefix(self, prefix: str) -> None:
        raise NotImplementedError

    def list_prefix(self, prefix: str) -> List[str]:
        raise NotImplementedError


class PosixStorage(StorageBackend):
    """Blobs are files under a root directory."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _abs(self, path: str) -> str:
        p = os.path.normpath(os.path.join(self.root, path))
        if p != self.root and not p.startswith(self.root + os.sep):
            raise StorageException(f"path escapes storage root: {path}")
        return p

    def read(self, path: str) -> bytes:
        try:
            with open(self._abs(path), "rb") as f:
                data = f.read()
        except FileNotFoundError as e:
            raise StorageException(f"not found: {path}") from e
        if _faults.ACTIVE:
            data = _faults.inject("storage.read", data, detail=path)
        return data

    def read_range(self, path: str, offset: int, size: int) -> bytes:
        try:
            with open(self._abs(path), "rb") as f:
                f.seek(offset)
                data = f.read(size)
        except FileNotFoundError as e:
            raise StorageException(f"not found: {path}") from e
        if _faults.ACTIVE:
            data = _faults.inject("storage.read", data, detail=path)
        return data

    def read_into(self, path: str, offset: int, view: memoryview) -> None:
        try:
            fd = os.open(self._abs(path), os.O_RDONLY)
        except FileNotFoundError as e:
            raise StorageException(f"not found: {path}") from e
        try:
            got = 0
            while got < len(view):
                n = os.preadv(fd, [view[got:]], offset + got)
                if n == 0:
                    raise StorageException(
                        f"short read ({got} of {len(view)} bytes at "
                        f"{offset}): {path}")
                got += n
        finally:
            os.close(fd)
        if _faults.ACTIVE:
            data = _faults.inject("storage.read", view, detail=path)
            if data is not view:
                view[:] = data

    def write(self, path: str, data: bytes, sync: bool = True) -> None:
        if _faults.ACTIVE:
            _faults.inject("storage.write", detail=path)
        p = self._abs(path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + f".tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            if sync:
                os.fsync(f.fileno())
        os.replace(tmp, p)

    def write_exclusive(self, path: str, data: bytes) -> bool:
        if _faults.ACTIVE:
            _faults.inject("storage.write", detail=path)
        p = self._abs(path)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        # write a private tmp first, then link() it into place: the blob
        # becomes visible fully written (a losing racer must never read a
        # partially-written marker), and link() fails with EEXIST for all
        # but exactly one concurrent creator
        tmp = p + f".xtmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, p)
            return True
        except FileExistsError:
            return False
        except OSError:
            # hard links are unsupported on gcsfuse and some NFS mounts
            # (EPERM/ENOTSUP/EOPNOTSUPP); fall back to O_CREAT|O_EXCL,
            # still atomic on POSIX though the loser may observe a
            # partially-written marker on non-POSIX overlays
            try:
                fd = os.open(p, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                return False
            try:
                os.write(fd, data)
                os.fsync(fd)
            finally:
                os.close(fd)
            return True
        finally:
            os.unlink(tmp)

    def exists(self, path: str) -> bool:
        return os.path.exists(self._abs(path))

    def size(self, path: str) -> int:
        try:
            return os.path.getsize(self._abs(path))
        except FileNotFoundError as e:
            raise StorageException(f"not found: {path}") from e

    def delete(self, path: str) -> None:
        try:
            os.remove(self._abs(path))
        except FileNotFoundError:
            pass

    def delete_prefix(self, prefix: str) -> None:
        import shutil
        p = self._abs(prefix)
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        elif os.path.exists(p):
            os.remove(p)

    def list_prefix(self, prefix: str) -> List[str]:
        p = self._abs(prefix)
        out: List[str] = []
        if not os.path.isdir(p):
            return out
        for dirpath, _dirs, files in os.walk(p):
            for fn in files:
                out.append(os.path.relpath(os.path.join(dirpath, fn), self.root))
        return sorted(out)

    def local_path(self, path: str) -> str:
        """Direct filesystem path — used to hand files to the C++ layer."""
        return self._abs(path)


class MemoryStorage(StorageBackend):
    """In-process blob store for unit tests."""

    def __init__(self):
        self._blobs: Dict[str, bytes] = {}
        self._lock = threading.Lock()

    def read(self, path: str) -> bytes:
        with self._lock:
            if path not in self._blobs:
                raise StorageException(f"not found: {path}")
            data = self._blobs[path]
        if _faults.ACTIVE:
            data = _faults.inject("storage.read", data, detail=path)
        return data

    def read_range(self, path: str, offset: int, size: int) -> bytes:
        return self.read(path)[offset:offset + size]

    def write(self, path: str, data: bytes, sync: bool = True) -> None:
        if _faults.ACTIVE:
            _faults.inject("storage.write", detail=path)
        with self._lock:
            self._blobs[path] = bytes(data)

    def write_exclusive(self, path: str, data: bytes) -> bool:
        if _faults.ACTIVE:
            _faults.inject("storage.write", detail=path)
        with self._lock:
            if path in self._blobs:
                return False
            self._blobs[path] = bytes(data)
            return True

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._blobs

    def size(self, path: str) -> int:
        return len(self.read(path))

    def delete(self, path: str) -> None:
        with self._lock:
            self._blobs.pop(path, None)

    @staticmethod
    def _under(name: str, prefix: str) -> bool:
        # path-component boundary: "tables/5" must not cover "tables/52"
        if not prefix:
            return True
        return name == prefix or name.startswith(prefix + "/")

    def delete_prefix(self, prefix: str) -> None:
        with self._lock:
            for k in [k for k in self._blobs if self._under(k, prefix)]:
                del self._blobs[k]

    def list_prefix(self, prefix: str) -> List[str]:
        with self._lock:
            return sorted(k for k in self._blobs if self._under(k, prefix))


def make_storage(storage_type: str, **kw) -> StorageBackend:
    db_path = kw.get("db_path")
    # a gs:// db_path selects GCS regardless of the declared type, so
    # `Client(db_path="gs://bucket/db")` just works
    if storage_type == "gcs" or (
            isinstance(db_path, str) and db_path.startswith("gs://")):
        from .gcs import GcsStorage
        if isinstance(db_path, str) and db_path.startswith("gs://"):
            return GcsStorage.from_url(db_path, client=kw.get("client"))
        if "bucket" not in kw:
            raise StorageException(
                "gcs storage requires a gs://bucket/prefix db_path or an "
                "explicit bucket= option")
        return GcsStorage(kw["bucket"], kw.get("prefix", ""),
                          client=kw.get("client"))
    if storage_type == "posix":
        return PosixStorage(kw["db_path"])
    if storage_type == "memory":
        return MemoryStorage()
    raise StorageException(f"unknown storage type: {storage_type}")
