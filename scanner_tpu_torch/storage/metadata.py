"""Database metadata descriptors and the on-disk path scheme.

Capability parity: reference scanner/metadata.proto (DatabaseDescriptor:6,
VideoDescriptor:63, TableDescriptor:120) and scanner/engine/metadata.{h,cpp}
(path scheme metadata.h:38-100, megafile write/read metadata.cpp).

Descriptors are plain dataclasses serialized with msgpack; numpy index arrays
are stored as raw little-endian buffers so the hot video index loads with a
single frombuffer (no per-element decode).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import msgpack
import numpy as np

from ..common import StorageException

FORMAT_VERSION = 1


# ---------------------------------------------------------------------------
# Path scheme (all relative to the database root)
# ---------------------------------------------------------------------------

def db_meta_path() -> str:
    return "db_metadata.bin"


def megafile_path() -> str:
    return "table_megafile.bin"


def table_dir(table_id: int) -> str:
    return f"tables/{table_id}"


def table_descriptor_path(table_id: int) -> str:
    return f"tables/{table_id}/descriptor.bin"


def column_item_path(table_id: int, column: str, item: int) -> str:
    return f"tables/{table_id}/{column}_{item}.bin"


def video_meta_path(table_id: int, column: str, item: int) -> str:
    return f"tables/{table_id}/{column}_{item}.vmeta"


def job_dir(job_id: int) -> str:
    return f"jobs/{job_id}"


def job_profile_path(job_id: int, node: str) -> str:
    return f"jobs/{job_id}/profile_{node}.trace"


def shard_prefix(shard: int = 0) -> str:
    """Control-plane namespace root of one master shard.  Shard 0 is
    the legacy unprefixed layout byte-for-byte (a pre-sharding db IS a
    one-shard db); shard k > 0 nests under `jobs/s<k>/` so each
    shard's generation claims, checkpoints and journals are disjoint —
    shard failover is single-master recovery scoped to one prefix
    (engine/shardmap.py)."""
    return "jobs" if not shard else f"jobs/s{int(shard):02d}"


def generation_prefix(shard: int = 0) -> str:
    """Directory of master-generation claim markers (one small blob per
    claimed generation; `write_exclusive` CAS makes each claim atomic —
    engine/journal.py claim_generation).  Scoped per control-plane
    shard (see shard_prefix)."""
    return f"{shard_prefix(shard)}/generations"


def generation_path(gen: int, shard: int = 0) -> str:
    return f"{generation_prefix(shard)}/{gen:08d}.bin"


def generation_dir(gen: int, shard: int = 0) -> str:
    """Per-generation control-plane state root: checkpoint, progress and
    journal of the master that claimed `gen` live under it, so a fenced
    (superseded) master's late writes can never clobber its successor's
    state — they land in a directory the successor never reads from
    again once recovery migrated the bulk."""
    return f"{shard_prefix(shard)}/g{gen:08d}"


def bulk_checkpoint_path(gen: Optional[int] = None,
                         shard: int = 0) -> str:
    """Active bulk job's admission state (spec blob + task geometry) —
    lets a restarted master resume the job (reference
    recover_and_init_database, master.cpp:1311).  Generation-scoped
    when `gen` is given; the legacy fixed path (pre-fencing masters)
    remains readable for recovery."""
    if gen is None:
        return f"{shard_prefix(shard)}/active_bulk.bin"
    return f"{generation_dir(gen, shard)}/active_bulk.bin"


def bulk_progress_path(gen: Optional[int] = None,
                       shard: int = 0) -> str:
    """Active bulk job's progress (done-set, blacklist, commits), written
    with each periodic checkpoint.  Generation-scoped when `gen` is
    given (see bulk_checkpoint_path)."""
    if gen is None:
        return f"{shard_prefix(shard)}/active_bulk_progress.bin"
    return f"{generation_dir(gen, shard)}/active_bulk_progress.bin"


def journal_dir(gen: int, shard: int = 0) -> str:
    """Write-ahead bulk-journal segments of one master generation
    (engine/journal.py)."""
    return f"{generation_dir(gen, shard)}/journal"


def journal_segment_path(gen: int, seg: int, shard: int = 0) -> str:
    return f"{journal_dir(gen, shard)}/seg_{seg:08d}.bin"


def shardmap_prefix() -> str:
    """Versioned shard-map epochs (engine/shardmap.py; one small blob
    per epoch, CAS-published, highest epoch wins)."""
    return "jobs/shardmap"


def shardmap_path(epoch: int) -> str:
    return f"{shardmap_prefix()}/e{epoch:08d}.bin"


# ---------------------------------------------------------------------------
# msgpack helpers with numpy support
# ---------------------------------------------------------------------------

def _default(obj):
    if isinstance(obj, np.ndarray):
        return {b"__nd__": True, b"d": obj.tobytes(), b"t": str(obj.dtype),
                b"s": list(obj.shape)}
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    raise TypeError(f"cannot serialize {type(obj)}")


def _ext_hook_obj(obj):
    if isinstance(obj, dict) and obj.get(b"__nd__"):
        return np.frombuffer(obj[b"d"], dtype=obj[b"t"]).reshape(obj[b"s"])
    return obj


def pack(obj) -> bytes:
    return msgpack.packb(obj, default=_default, use_bin_type=True)


def unpack(data: bytes):
    return msgpack.unpackb(data, object_hook=_ext_hook_obj, raw=False,
                           strict_map_key=False)


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------

class ColumnType(enum.IntEnum):
    BYTES = 0
    VIDEO = 1


@dataclass
class VideoDescriptor:
    """Index for one stored encoded-video item.

    Unlike the reference's H.264-specific NAL index
    (h264_byte_stream_index_creator.h:31-57), this index is codec-agnostic:
    the demuxer records per-sample offsets/sizes/keyframe flags in *decode
    order* straight from the container, so any libavcodec codec works; H.264
    remains the fast path for encode output.
    """

    width: int = 0
    height: int = 0
    fps: float = 0.0
    num_frames: int = 0
    codec: str = "h264"
    # decoder configuration record (e.g. avcC / SPS+PPS)
    extradata: bytes = b""
    # per-sample byte offset into the packet stream file, decode order
    sample_offsets: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint64))
    sample_sizes: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint64))
    # indices (into decode order) of keyframe samples, ascending
    keyframe_indices: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # pts/dts per sample (source time base), decode order; pts maps decode
    # order -> display order, dts is needed to remux B-frame streams
    sample_pts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    sample_dts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    # time base of pts/dts as a rational
    tb_num: int = 1
    tb_den: int = 30
    # path of the packet-stream blob this index describes; "" = column item
    # file itself (normal ingest), otherwise an absolute path (in-place ingest
    # of an external mp4 keeps data where it is - reference ingest.cpp:382)
    data_path: str = ""
    # if data_path points at an external container, samples are (offset,size)
    # into that file

    def to_dict(self) -> dict:
        return {
            "width": self.width, "height": self.height, "fps": self.fps,
            "num_frames": self.num_frames, "codec": self.codec,
            "extradata": self.extradata,
            "sample_offsets": np.asarray(self.sample_offsets, np.uint64),
            "sample_sizes": np.asarray(self.sample_sizes, np.uint64),
            "keyframe_indices": np.asarray(self.keyframe_indices, np.int64),
            "sample_pts": np.asarray(self.sample_pts, np.int64),
            "sample_dts": np.asarray(self.sample_dts, np.int64),
            "tb_num": self.tb_num, "tb_den": self.tb_den,
            "data_path": self.data_path,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "VideoDescriptor":
        return cls(**d)

    def serialize(self) -> bytes:
        return pack(self.to_dict())

    @classmethod
    def deserialize(cls, data: bytes) -> "VideoDescriptor":
        return cls.from_dict(unpack(data))


@dataclass
class ColumnDescriptor:
    name: str
    type: ColumnType = ColumnType.BYTES
    # row codec: "raw" (bytes as written), "pickle" (python objects),
    # "video" (encoded frames)
    codec: str = "raw"

    def to_dict(self) -> dict:
        return {"name": self.name, "type": int(self.type),
                "codec": self.codec}

    @classmethod
    def from_dict(cls, d: dict) -> "ColumnDescriptor":
        return cls(name=d["name"], type=ColumnType(d["type"]),
                   codec=d.get("codec", "raw"))


@dataclass
class TableDescriptor:
    """One stored table (a set of aligned named streams).

    `end_rows[i]` is the exclusive end row of item i; item files hold rows
    [end_rows[i-1], end_rows[i]).  Item boundaries are fixed at job-admission
    time (io-packet boundaries), so workers write items independently and the
    master commits the table once all are present — same recovery model as
    the reference (metadata.proto:120, master.cpp:1619-1663).
    """

    id: int
    name: str
    columns: List[ColumnDescriptor] = field(default_factory=list)
    end_rows: List[int] = field(default_factory=list)
    job_id: int = -1
    timestamp: float = 0.0

    @property
    def num_rows(self) -> int:
        return self.end_rows[-1] if self.end_rows else 0

    def column_names(self) -> List[str]:
        return [c.name for c in self.columns]

    def column_type(self, name: str) -> ColumnType:
        for c in self.columns:
            if c.name == name:
                return c.type
        raise StorageException(f"table {self.name}: no column {name}")

    def item_of_row(self, row: int) -> int:
        """Index of the item containing global row `row`."""
        lo = int(np.searchsorted(np.asarray(self.end_rows), row, side="right"))
        if lo >= len(self.end_rows):
            raise StorageException(
                f"table {self.name}: row {row} out of range ({self.num_rows})")
        return lo

    def item_bounds(self, item: int) -> Tuple[int, int]:
        start = self.end_rows[item - 1] if item > 0 else 0
        return start, self.end_rows[item]

    def to_dict(self) -> dict:
        return {
            "id": self.id, "name": self.name,
            "columns": [c.to_dict() for c in self.columns],
            "end_rows": list(self.end_rows),
            "job_id": self.job_id, "timestamp": self.timestamp,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TableDescriptor":
        return cls(id=d["id"], name=d["name"],
                   columns=[ColumnDescriptor.from_dict(c) for c in d["columns"]],
                   end_rows=list(d["end_rows"]), job_id=d["job_id"],
                   timestamp=d.get("timestamp", 0.0))

    def serialize(self) -> bytes:
        return pack(self.to_dict())

    @classmethod
    def deserialize(cls, data: bytes) -> "TableDescriptor":
        return cls.from_dict(unpack(data))


@dataclass
class DatabaseMetadata:
    """Authoritative name->id map plus commit flags.

    Mirrors reference DatabaseDescriptor (metadata.proto:6-30): a table is
    visible to readers only once committed; failed jobs leave uncommitted
    tables which are ignored and reclaimed.
    """

    next_table_id: int = 0
    next_job_id: int = 0
    # name -> table id
    tables: Dict[str, int] = field(default_factory=dict)
    committed: Dict[int, bool] = field(default_factory=dict)

    def has_table(self, name: str) -> bool:
        return name in self.tables

    def table_id(self, name: str) -> int:
        if name not in self.tables:
            raise StorageException(f"no such table: {name}")
        return self.tables[name]

    def table_is_committed(self, name: str) -> bool:
        return self.has_table(name) and self.committed.get(self.tables[name], False)

    def add_table(self, name: str) -> int:
        if name in self.tables:
            raise StorageException(f"table already exists: {name}")
        tid = self.next_table_id
        self.next_table_id += 1
        self.tables[name] = tid
        self.committed[tid] = False
        return tid

    def remove_table(self, name: str) -> int:
        tid = self.tables.pop(name)
        self.committed.pop(tid, None)
        return tid

    def commit_table(self, tid: int) -> None:
        self.committed[tid] = True

    def new_job_id(self) -> int:
        jid = self.next_job_id
        self.next_job_id += 1
        return jid

    def serialize(self) -> bytes:
        return pack({
            "version": FORMAT_VERSION,
            "next_table_id": self.next_table_id,
            "next_job_id": self.next_job_id,
            "tables": self.tables,
            "committed": {str(k): v for k, v in self.committed.items()},
        })

    @classmethod
    def deserialize(cls, data: bytes) -> "DatabaseMetadata":
        d = unpack(data)
        version = d.get("version", 0)
        if version != FORMAT_VERSION:
            raise StorageException(
                f"unsupported db metadata version {version} "
                f"(expected {FORMAT_VERSION})")
        return cls(next_table_id=d["next_table_id"],
                   next_job_id=d["next_job_id"],
                   tables=dict(d["tables"]),
                   committed={int(k): v for k, v in d["committed"].items()})
