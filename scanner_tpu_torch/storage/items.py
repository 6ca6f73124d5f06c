"""Column item-file format.

One item file holds the serialized rows of one column for one row range.
Layout (little-endian), versions 2/3:

    magic   u32  = 0x53434954 ("SCIT")
    version u32  (2 = crc is crc32c/Castagnoli, 3 = crc is zlib crc32)
    nrows   u64
    crc     u32  checksum of the whole item with this field zeroed —
                 header INCLUDED, so rot in nrows (which shifts every
                 payload offset) is caught, not just payload rot
    sizes   u64[nrows]   (NULL_SIZE marks a null row)
    payloads, concatenated

The sizes header is fixed-position so a reader can fetch it with one ranged
read and then fetch only the rows it needs — the sparse-read path the
reference implements in ColumnSource (column_source.cpp, sparse vs dense via
load_sparsity_threshold).

The checksum is verified on every whole-item read (the dense path —
sparse ranged reads skip it, matching the reference where per-range
integrity rides on the transport).  A mismatch raises
``ItemCorruptionError`` — a StorageException subclass the cluster
treats as a *transient* task failure (engine/service.py FailedWork
classification): the task requeues and re-reads instead of striking
its job toward the blacklist, because bit rot on one replica/read is
retryable while a poisoned kernel is not.  Version-1 items (no crc)
remain readable so pre-existing databases survive the upgrade.

crc32c comes from google_crc32c (C-accelerated; declared in
setup.py).  The checksum ALGORITHM is recorded in the version field,
so nodes with differing installs can never misread a valid item as
corrupt: a writer without google_crc32c falls back to zlib.crc32 and
stamps version 3; a reader without google_crc32c skips verification
of version-2 items (logged once) instead of guessing.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from ..common import NullElement, StorageException
from ..util import metrics as _mx
from .backend import StorageBackend

MAGIC = 0x53434954
VERSION_CRC32C = 2   # crc field is crc32c (Castagnoli)
VERSION_CRC32 = 3    # crc field is zlib crc32 (no-google_crc32c fallback)
NULL_SIZE = 0xFFFFFFFFFFFFFFFF
_HEADER_V1 = struct.Struct("<IIQ")
_HEADER_V2 = struct.Struct("<IIQI")  # shared by versions 2 and 3
# the largest header any version uses; ranged header reads fetch this
# many bytes and let the version field decide how much is meaningful
HEADER_MAX = _HEADER_V2.size
# read_item_rows_into's first ranged read: the header and, for items of
# up to (SIZES_PREFIX - HEADER_MAX) // 8 = 4093 rows, every row's size
SIZES_PREFIX = 32 << 10

RowData = Union[bytes, NullElement]

_M_CORRUPTIONS = _mx.registry().counter(
    "scanner_tpu_item_corruptions_total",
    "Stored-item reads whose crc32c checksum did not match — corrupted "
    "bytes detected and surfaced as a retryable StorageException.")


class ItemCorruptionError(StorageException):
    """Item bytes failed their crc32c check.  Retryable: re-reading (or
    re-assigning the task to another worker) may succeed."""


import zlib

try:
    import google_crc32c

    def _crc32c_extend(crc: int, chunk: bytes) -> int:
        # google_crc32c's C layer accepts only `bytes` chunks
        return int(google_crc32c.extend(crc, chunk))
except ImportError:  # pragma: no cover - env ships the C lib
    _crc32c_extend = None

_HAVE_CRC32C = _crc32c_extend is not None

# write with the strongest available algorithm, stamped in the version
_WRITE_VERSION = VERSION_CRC32C if _HAVE_CRC32C else VERSION_CRC32
_warned_unverifiable = False

# bound on the per-chunk bytes copy the crc32c C API forces when
# hashing a read buffer (the zlib path hashes a zero-copy memoryview)
_CRC_CHUNK = 4 << 20


def _checksum_parts(version: int, parts) -> int:
    """Incremental checksum over byte chunks — the write path hashes
    the sizes array + payloads in place instead of materializing the
    joined body twice."""
    crc = 0
    if version == VERSION_CRC32C:
        for p in parts:
            crc = _crc32c_extend(crc, p)
        return crc
    for p in parts:
        crc = zlib.crc32(p, crc)
    return crc & 0xFFFFFFFF


def _checksum_stream(version: int, hdr0: bytes, buf, start: int) -> int:
    """Checksum hdr0 + buf[start:] without materializing the tail as
    one big copy: zlib hashes a zero-copy memoryview; crc32c (whose C
    layer only accepts bytes) hashes bounded-size chunks."""
    if version == VERSION_CRC32C:
        crc = _crc32c_extend(0, hdr0)
        mv = memoryview(buf)
        for off in range(start, len(buf), _CRC_CHUNK):
            crc = _crc32c_extend(crc, bytes(mv[off:off + _CRC_CHUNK]))
        return crc
    return zlib.crc32(memoryview(buf)[start:], zlib.crc32(hdr0)) \
        & 0xFFFFFFFF


def build_item(rows: Sequence[RowData]) -> bytes:
    sizes = np.empty(len(rows), dtype=np.uint64)
    payloads: List[bytes] = []
    for i, r in enumerate(rows):
        if isinstance(r, NullElement):
            sizes[i] = NULL_SIZE
        else:
            b = bytes(r)
            sizes[i] = len(b)
            payloads.append(b)
    parts = [sizes.tobytes()] + payloads
    # checksum spans the header too (crc field zeroed): a flipped bit
    # in nrows would silently re-base every payload offset otherwise
    hdr0 = _HEADER_V2.pack(MAGIC, _WRITE_VERSION, len(rows), 0)
    crc = _checksum_parts(_WRITE_VERSION, [hdr0] + parts)
    return b"".join(
        [_HEADER_V2.pack(MAGIC, _WRITE_VERSION, len(rows), crc)] + parts)


def write_item(backend: StorageBackend, path: str, rows: Sequence[RowData]) -> None:
    backend.write(path, build_item(rows))


def _parse_header(buf: bytes, path: str) -> Tuple[int, int, int,
                                                  Optional[int]]:
    """-> (nrows, header_size, version, crc-or-None for v1)."""
    if len(buf) < _HEADER_V1.size:
        raise StorageException(f"item file too short: {path}")
    magic, version, nrows = _HEADER_V1.unpack_from(buf, 0)
    if magic != MAGIC:
        raise StorageException(f"bad item magic in {path}")
    if version == 1:
        return nrows, _HEADER_V1.size, version, None
    if version in (VERSION_CRC32C, VERSION_CRC32):
        if len(buf) < _HEADER_V2.size:
            raise StorageException(f"item file too short: {path}")
        _m, _v, nrows, crc = _HEADER_V2.unpack_from(buf, 0)
        return nrows, _HEADER_V2.size, version, crc
    raise StorageException(f"unsupported item version {version} in {path}")


def _verify(buf: bytes, hdr: int, version: int, nrows: int, crc: int,
            path: str) -> None:
    global _warned_unverifiable
    if version == VERSION_CRC32C and not _HAVE_CRC32C:
        # written by a node WITH google_crc32c, read by one without:
        # skipping verification beats the alternative — guessing with a
        # different polynomial would flag every valid item as corrupt
        # and burn the whole transient-retry budget on phantom rot
        if not _warned_unverifiable:
            _warned_unverifiable = True
            from ..util.log import get_logger
            get_logger("storage").warning(
                "google_crc32c unavailable: crc32c item checksums "
                "(version 2) cannot be verified on this node")
        return
    hdr0 = _HEADER_V2.pack(MAGIC, version, nrows, 0)
    if _checksum_stream(version, hdr0, buf, hdr) != crc:
        _M_CORRUPTIONS.inc()
        raise ItemCorruptionError(
            f"item checksum mismatch ({len(buf)} bytes): {path}")


# ---------------------------------------------------------------------------
# sealed control-plane blobs (bulk checkpoint / journal payloads)
# ---------------------------------------------------------------------------

# distinct magic so a sealed blob can never be confused with an item
# file or a legacy (unsealed) checkpoint
BLOB_MAGIC = 0x53434B50  # "SCKP"
_BLOB_HDR = struct.Struct("<III")  # magic, checksum-algo version, crc


def checksum_blob(payload: bytes) -> Tuple[int, int]:
    """(algorithm version, crc) of one payload with the strongest
    available algorithm — the same crc32c/zlib selection item files use
    (the algorithm travels with the data, so mixed installs never
    misread valid bytes as corrupt)."""
    return _WRITE_VERSION, _checksum_parts(_WRITE_VERSION, [payload])


def verify_blob_checksum(version: int, crc: int, payload: bytes,
                         path: str = "") -> None:
    """Raise ItemCorruptionError when `payload` fails its recorded
    checksum.  A crc32c-stamped blob on a node without google_crc32c is
    skipped (same contract as item verification: never guess with the
    wrong polynomial)."""
    global _warned_unverifiable
    if version == VERSION_CRC32C and not _HAVE_CRC32C:
        if not _warned_unverifiable:
            _warned_unverifiable = True
            from ..util.log import get_logger
            get_logger("storage").warning(
                "google_crc32c unavailable: crc32c item checksums "
                "(version 2) cannot be verified on this node")
        return
    if version not in (VERSION_CRC32C, VERSION_CRC32):
        raise StorageException(
            f"unsupported blob checksum version {version} in {path}")
    if _checksum_parts(version, [payload]) != crc:
        raise ItemCorruptionError(
            f"sealed blob checksum mismatch ({len(payload)} bytes): "
            f"{path}")


def seal_blob(payload: bytes) -> bytes:
    """Wrap a control-plane payload (bulk checkpoint, progress
    snapshot) with a checksummed header, so rot in the master's
    recovery state is *detected* at restart instead of silently
    resurrecting a half-garbage bulk (engine/service.py
    `_recover_bulk` falls back to journal replay on a corrupt
    checkpoint)."""
    version, crc = checksum_blob(payload)
    return _BLOB_HDR.pack(BLOB_MAGIC, version, crc) + payload


def open_blob(data: bytes, path: str = "") -> bytes:
    """Verify + unwrap a sealed blob.  Raises StorageException when the
    data is not a sealed blob at all (callers may fall back to treating
    it as a legacy unsealed payload) and ItemCorruptionError when the
    checksum fails."""
    if len(data) < _BLOB_HDR.size:
        raise StorageException(f"not a sealed blob (too short): {path}")
    magic, version, crc = _BLOB_HDR.unpack_from(data, 0)
    if magic != BLOB_MAGIC:
        raise StorageException(f"not a sealed blob: {path}")
    payload = data[_BLOB_HDR.size:]
    verify_blob_checksum(version, crc, payload, path)
    return payload


def read_item(backend: StorageBackend, path: str) -> List[Optional[bytes]]:
    """Read every row of an item. Null rows come back as None."""
    buf = backend.read(path)
    nrows, hdr, version, crc = _parse_header(buf, path)
    if crc is not None:
        _verify(buf, hdr, version, nrows, crc, path)
    sizes = np.frombuffer(buf, dtype=np.uint64, count=nrows, offset=hdr)
    out: List[Optional[bytes]] = []
    off = hdr + 8 * nrows
    for s in sizes:
        if s == NULL_SIZE:
            out.append(None)
        else:
            s = int(s)
            out.append(buf[off:off + s])
            off += s
    return out


def read_item_rows(backend: StorageBackend, path: str,
                   local_rows: Sequence[int],
                   sparsity_threshold: int = 8) -> List[Optional[bytes]]:
    """Read selected rows (local indices) from an item, each as bytes
    of its own: `read_item_rows_into` with a buffer of this call's.

    If the requested rows are dense relative to the item, the whole file is
    fetched with one read (checksum-verified); otherwise the sizes header is
    read first and each run of adjacent rows fetched with a ranged read.
    """
    return [None if v is None else bytes(v)
            for v in read_item_rows_into(backend, path, local_rows,
                                         RowBuffer(), sparsity_threshold)]


class RowBuffer:
    """Memory one reading thread keeps across its reads of stored rows
    (`read_item_rows_into`).  The rows of a read land in it, and it is
    reallocated only when a read needs more room than it has.  The views
    a read hands out stay valid until the next `start()`.

    `grew` says whether the reads since `start()` allocated (a larger
    buffer, or a dense read's whole item), `reads` how many backend
    reads they issued."""

    def __init__(self) -> None:
        self._buf = bytearray()
        self._used = 0
        self.grew = False
        self.reads = 0

    def start(self) -> None:
        """Begin a read: the views of the previous one may be
        overwritten from here on."""
        self._used = 0
        self.grew = False
        self.reads = 0

    def take(self, n: int) -> memoryview:
        """The next `n` bytes of the buffer, as a writable view."""
        end = self._used + n
        if end > len(self._buf):
            # a new array, not a resize: views already handed out keep
            # the old one alive; room for this whole read, and a quarter
            # more, so that the next read of a like size fits
            self._buf = bytearray(end + end // 4)
            self._used, end = 0, n
            self.grew = True
        view = memoryview(self._buf)[self._used:end]
        self._used = end
        return view


def read_item_rows_into(backend: StorageBackend, path: str,
                        local_rows: Sequence[int], buf: RowBuffer,
                        sparsity_threshold: int = 8
                        ) -> List[Optional[Union[bytes, memoryview]]]:
    """Read selected rows (local indices) from an item into `buf`: one
    memoryview of the buffer for each requested row, valid until
    `buf.start()`, and None for a null row.

    Rows dense relative to the item (rows × `sparsity_threshold` ≥ the
    item's rows) come from one read of the whole item, checksum-verified,
    as bytes.  Otherwise one ranged read fetches the header and the
    sizes (two when they pass SIZES_PREFIX), then one `read_into` fetches
    each run of adjacent requested rows, in file order.
    """
    if len(local_rows) == 0:
        return []
    head = backend.read_range(path, 0, SIZES_PREFIX)
    buf.reads += 1
    nrows, hdr, _ver, _crc = _parse_header(head, path)
    if nrows == 0:
        raise StorageException(f"empty item: {path}")
    if len(local_rows) * sparsity_threshold >= nrows:
        all_rows = read_item(backend, path)
        buf.reads += 1
        buf.grew = True
        return [all_rows[r] for r in local_rows]
    rows = np.asarray(local_rows, dtype=np.int64)
    bad = rows[(rows < 0) | (rows >= nrows)]
    if len(bad):
        raise StorageException(
            f"row {bad[0]} out of item bounds ({nrows}): {path}")
    if len(head) >= hdr + 8 * nrows:
        sizes = np.frombuffer(head, dtype=np.uint64, count=nrows,
                              offset=hdr)
    else:
        sizes_buf = backend.read_range(path, hdr, 8 * nrows)
        buf.reads += 1
        if len(sizes_buf) != 8 * nrows:
            raise StorageException(f"item file too short: {path}")
        sizes = np.frombuffer(sizes_buf, dtype=np.uint64, count=nrows)
    null = sizes == NULL_SIZE
    # starts[r]: row r's payload offset; starts[r + 1] - starts[r] its size
    starts = np.zeros(nrows + 1, dtype=np.int64)
    np.cumsum(np.where(null, 0, sizes).astype(np.int64), out=starts[1:])
    base = hdr + 8 * nrows
    want = np.unique(rows)
    cut = np.flatnonzero(np.diff(want) != 1) + 1
    firsts, lasts = want[np.r_[0, cut]], want[np.r_[cut - 1, len(want) - 1]]
    runs = []
    for first, last in zip(firsts.tolist(), lasts.tolist()):
        lo, hi = int(starts[first]), int(starts[last + 1])
        if hi == lo:
            view = memoryview(b"")
        else:
            view = buf.take(hi - lo)
            backend.read_into(path, base + lo, view)
            buf.reads += 1
        runs.append((lo, view))
    out: List[Optional[memoryview]] = []
    for r, k in zip(rows.tolist(),
                    (np.searchsorted(firsts, rows, side="right") - 1
                     ).tolist()):
        if null[r]:
            out.append(None)
        else:
            lo, view = runs[k]
            out.append(view[starts[r] - lo:starts[r + 1] - lo])
    return out


def item_num_rows(backend: StorageBackend, path: str) -> int:
    header = backend.read_range(path, 0, HEADER_MAX)
    return _parse_header(header, path)[0]


# kept for external readers of the "current" write format
VERSION = _WRITE_VERSION
