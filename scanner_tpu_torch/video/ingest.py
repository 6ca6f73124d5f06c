"""Video ingest into the database, mp4 export, and synthetic test clips.

Capability parity: reference ingest path (ingest.cpp:867 ingest_videos,
parse_and_write_video:175, parse_video_inplace:382) and storage.py save_mp4.

An ingested video becomes a committed table with columns
['index', 'frame']: 'index' stores the row number (8-byte LE) and 'frame'
is a VIDEO column whose single item is the demuxed packet stream, described
by a VideoDescriptor side file.
"""

from __future__ import annotations

import os
import struct
import tempfile
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..common import ScannerException
from ..storage import items
from ..storage import metadata as md
from ..storage.backend import PosixStorage
from ..storage.database import Database
from . import lib
from .automata import DecoderAutomata


def ingest_videos(
        db: Database, named_paths: Sequence[Tuple[str, str]],
        inplace: bool = False, force: bool = False,
) -> Tuple[List[md.TableDescriptor], List[Tuple[str, str]]]:
    """Ingest videos as named tables; returns (descriptors, failures).

    One corrupt file must not abort a corpus ingest: per-video failures
    are collected as (path, reason) and returned alongside the tables
    that did ingest (reference ingest.cpp:872-978 failed_videos and
    client.py:965 ingest_videos -> (tables, failures)).  A failed video
    leaves no table behind.  inplace=True indexes the original file
    without copying packet data (reference ingest.cpp:382); force=True
    deletes an existing table of the same name first.
    """
    if not named_paths:
        raise ScannerException("must ingest at least one video")
    # a name collision (with an existing table, or within the list) is a
    # caller error, not a per-video decode failure: raise up front like
    # the reference (client.py:1005), before any work or deletion
    names = [name for name, _ in named_paths]
    if len(set(names)) != len(names):
        dup = sorted({n for n in names if names.count(n) > 1})
        raise ScannerException(f"duplicate table names in ingest: {dup}")
    if not force:
        for name in names:
            if db.has_table(name):
                raise ScannerException(f"table already exists: {name}")
    out: List[md.TableDescriptor] = []
    failures: List[Tuple[str, str]] = []
    for name, path in named_paths:
        # with force=, delete a colliding table only immediately before
        # its own ingest attempt — never up front for the whole list, so
        # an abort partway cannot leave later tables deleted-but-never-
        # re-ingested.  (A failed forced re-ingest still loses the old
        # table: create-then-rename would be needed to avoid that.)
        if force and db.has_table(name):
            db.delete_table(name)
        try:
            out.append(_ingest_one(db, name, path, inplace))
        except ScannerException as e:
            failures.append((path, str(e)))
    return out, failures


def _ingest_one(db: Database, name: str, path: str,
                inplace: bool) -> md.TableDescriptor:
    if db.has_table(name):
        raise ScannerException(f"table already exists: {name}")
    cols = [md.ColumnDescriptor("index", md.ColumnType.BYTES),
            md.ColumnDescriptor("frame", md.ColumnType.VIDEO)]
    if inplace:
        vd = lib.ingest_file(path, None)
        desc = db.create_table(name, cols, end_rows=[vd.num_frames])
    else:
        desc = None
        tmp_path = None
        try:
            if isinstance(db.backend, PosixStorage):
                # write the packet stream straight into storage
                desc = db.create_table(name, cols, end_rows=[0])
                item_rel = md.column_item_path(desc.id, "frame", 0)
                target = db.backend.local_path(item_rel)
                os.makedirs(os.path.dirname(target), exist_ok=True)
                vd = lib.ingest_file(path, target)
            else:
                fd, tmp_path = tempfile.mkstemp(suffix=".pkts")
                os.close(fd)
                vd = lib.ingest_file(path, tmp_path)
                desc = db.create_table(name, cols, end_rows=[0])
                with open(tmp_path, "rb") as f:
                    db.backend.write(md.column_item_path(desc.id, "frame", 0),
                                     f.read())
        except Exception:
            # don't leave an orphaned uncommitted table squatting the name
            if desc is not None:
                db.delete_table(name)
            raise
        finally:
            if tmp_path:
                os.unlink(tmp_path)
        desc.end_rows = [vd.num_frames]
        db.write_table_descriptor(desc)
    db.backend.write(md.video_meta_path(desc.id, "frame", 0), vd.serialize())
    # index column: row number, one item
    idx_rows = [struct.pack("<q", i) for i in range(vd.num_frames)]
    items.write_item(db.backend, md.column_item_path(desc.id, "index", 0),
                     idx_rows)
    db.commit_table(desc.id)
    return db.table_descriptor(desc.id)


def ingest_images(db: Database, name: str, paths: Sequence[str]
                  ) -> md.TableDescriptor:
    """Ingest still images as a frame table (reference ingest.cpp image
    ingest).  Images stay in their encoded form (codec 'image'); readers
    and the engine decode to RGB numpy on demand via PIL."""
    if db.has_table(name):
        raise ScannerException(f"table already exists: {name}")
    cols = [md.ColumnDescriptor("index", md.ColumnType.BYTES),
            md.ColumnDescriptor("frame", md.ColumnType.BYTES,
                                codec="image")]
    blobs = []
    for p in paths:
        with open(p, "rb") as f:
            blobs.append(f.read())
    desc = db.create_table(name, cols, end_rows=[len(paths)])
    try:
        items.write_item(db.backend,
                         md.column_item_path(desc.id, "frame", 0), blobs)
        items.write_item(db.backend,
                         md.column_item_path(desc.id, "index", 0),
                         [struct.pack("<q", i) for i in range(len(paths))])
    except Exception:
        # don't leave an orphaned uncommitted table squatting the name
        db.delete_table(name)
        raise
    db.commit_table(desc.id)
    return desc


def decode_image(blob: bytes) -> np.ndarray:
    import io

    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(blob)).convert("RGB"))


def load_video_meta(db: Database, table, column: str = "frame",
                    item: int = 0) -> md.VideoDescriptor:
    desc = db.table_descriptor(table)
    return md.VideoDescriptor.deserialize(
        db.backend.read(md.video_meta_path(desc.id, column, item)))


def open_automata(db: Database, table, column: str = "frame",
                  n_threads: int = 1) -> DecoderAutomata:
    desc = db.table_descriptor(table)
    vd = load_video_meta(db, table, column)
    return DecoderAutomata(db.backend, vd,
                           md.column_item_path(desc.id, column, 0),
                           n_threads=n_threads)


def load_frames(db: Database, table, rows: Sequence[int],
                column: str = "frame") -> np.ndarray:
    """Client-side exact frame read across item boundaries (reference
    storage.py NamedVideoStream.load / as_hwang).  Rows are global display
    indices; job-output tables store one independently-decodable video item
    per task."""
    desc = db.table_descriptor(table)
    rows_l = [int(r) for r in rows]
    if not rows_l:
        vd0 = load_video_meta(db, table, column, 0)
        return np.zeros((0, vd0.height, vd0.width, 3), np.uint8)
    by_item: dict = {}
    for r in rows_l:
        item = desc.item_of_row(r)
        start, _ = desc.item_bounds(item)
        by_item.setdefault(item, []).append(r - start)
    frames: dict = {}
    for item, local in by_item.items():
        start, _ = desc.item_bounds(item)
        vd = md.VideoDescriptor.deserialize(
            db.backend.read(md.video_meta_path(desc.id, column, item)))
        auto = DecoderAutomata(db.backend, vd,
                               md.column_item_path(desc.id, column, item))
        try:
            got = auto.get_frames(local)
        finally:
            auto.close()
        for lr, f in zip(local, got):
            frames[start + lr] = f
    return np.stack([frames[r] for r in rows_l])


def iter_frames(db: Database, table, rows: Sequence[int],
                column: str = "frame", chunk: int = 64):
    """Yield decoded frames in request order, keeping one DecoderAutomata
    per item alive across chunks (streaming flavor of load_frames)."""
    desc = db.table_descriptor(table)
    rows_l = [int(r) for r in rows]
    autos: dict = {}
    try:
        for i in range(0, len(rows_l), chunk):
            part = rows_l[i:i + chunk]
            by_item: dict = {}
            for r in part:
                it = desc.item_of_row(r)
                start, _ = desc.item_bounds(it)
                by_item.setdefault(it, []).append(r - start)
            frames: dict = {}
            for it, local in by_item.items():
                start, _ = desc.item_bounds(it)
                if it not in autos:
                    vd = md.VideoDescriptor.deserialize(db.backend.read(
                        md.video_meta_path(desc.id, column, it)))
                    autos[it] = DecoderAutomata(
                        db.backend, vd,
                        md.column_item_path(desc.id, column, it))
                got = autos[it].get_frames(local)
                for lr, f in zip(local, got):
                    frames[start + lr] = f
            for r in part:
                yield frames[r]
    finally:
        for a in autos.values():
            a.close()


def export_mp4(db: Database, table, out_path: str,
               column: str = "frame") -> None:
    """Remux a stored video column to an .mp4 without re-encoding
    (reference storage.py:365 save_mp4)."""
    desc = db.table_descriptor(table)
    data_parts = []
    sizes_l, keys_l, pts_l, dts_l = [], [], [], []
    vd0: Optional[md.VideoDescriptor] = None
    pts_base = 0
    for item in range(len(desc.end_rows)):
        vd = md.VideoDescriptor.deserialize(
            db.backend.read(md.video_meta_path(desc.id, column, item)))
        if vd0 is None:
            vd0 = vd
        elif (vd.tb_num, vd.tb_den) != (vd0.tb_num, vd0.tb_den):
            raise ScannerException(
                "export_mp4: items have differing time bases")
        if vd.data_path:
            with open(vd.data_path, "rb") as f:
                raw = f.read()
            for o, s in zip(vd.sample_offsets, vd.sample_sizes):
                data_parts.append(raw[int(o):int(o) + int(s)])
        else:
            data_parts.append(db.backend.read(
                md.column_item_path(desc.id, column, item)))
        sizes_l.append(np.asarray(vd.sample_sizes, np.uint64))
        kf = np.zeros(vd.num_frames, np.uint8)
        kf[np.asarray(vd.keyframe_indices, np.int64)] = 1
        keys_l.append(kf)
        # shift each item's timestamps so concatenated items play back to
        # back (multi-item tables are always this library's own encodes,
        # which stamp frame-number pts starting at 0)
        pts = np.asarray(vd.sample_pts, np.int64)
        dts = np.asarray(vd.sample_dts, np.int64)
        shift = pts_base - int(pts.min())
        pts_l.append(pts + shift)
        dts_l.append(dts + shift)
        pts_base = int(pts_l[-1].max()) + _pts_step(vd)
    assert vd0 is not None
    lib.write_mp4(out_path, vd0.width, vd0.height, vd0.fps or 30.0,
                  vd0.codec, vd0.extradata, b"".join(data_parts),
                  np.concatenate(sizes_l), np.concatenate(keys_l),
                  np.concatenate(pts_l), np.concatenate(dts_l),
                  tb=(vd0.tb_num, vd0.tb_den))


def _pts_step(vd: md.VideoDescriptor) -> int:
    """Typical pts increment between consecutive display frames."""
    pts = np.sort(np.asarray(vd.sample_pts, np.int64))
    if len(pts) < 2:
        return 1
    diffs = np.diff(pts)
    diffs = diffs[diffs > 0]
    return int(np.median(diffs)) if len(diffs) else 1


# ---------------------------------------------------------------------------
# Synthetic clips for tests/benchmarks (replaces the reference's downloaded
# GCS fixtures, py_test.py:81 — this environment has no network egress)
# ---------------------------------------------------------------------------

def frame_pattern(i: int, height: int, width: int) -> np.ndarray:
    """Deterministic per-frame pattern: R channel encodes i%14 with 16-unit
    spacing, wide enough to survive lossy H.264 quantization."""
    f = np.zeros((height, width, 3), np.uint8)
    f[:, :, 0] = (i * 16) % 224
    f[:, :, 1] = np.linspace(0, 239, width, dtype=np.uint8)[None, :]
    sq = max(4, height // 8)
    x = (i * 5) % max(1, width - sq)
    f[:sq, x:x + sq, 2] = 230
    return f


def frame_pattern_id(frame: np.ndarray) -> int:
    """Recover i%14 from a decoded pattern frame (R is ~(i*16)%224)."""
    r = float(frame[..., 0].mean())
    return int(round(r / 16.0)) % 14


def encode_frames_mp4(path: str, frames, width: int, height: int,
                      fps: float = 24.0, keyint: int = 12,
                      crf: int = 18, bframes: int = 0,
                      open_gop: bool = False,
                      frame_pts=None, codec: str = "libx264") -> None:
    """Encode an iterable of (H, W, 3) uint8 frames to an .mp4.

    bframes>0 produces a reordered (pts!=dts) stream like real-world
    encodes; open_gop=True additionally uses non-IDR recovery-point
    keyframes (leading B frames reference across GOP boundaries);
    frame_pts (iterable of int, 1/fps ticks, strictly increasing)
    produces a variable-frame-rate stream — the three fixture knobs for
    real-world-stream decode tests.  `codec` is any libavcodec encoder
    name (libx264 default; libx265/mpeg4/... produce fixtures for the
    codec-agnostic ingest/decode path — the container records the
    encoder's own descriptor, so unmapped names cannot mislabel the
    stream).  crf and open_gop are honored for libx264 and libx265;
    other encoders use their libavcodec defaults."""
    enc = lib.Encoder(width, height, fps=fps, keyint=keyint, crf=crf,
                      bframes=bframes, open_gop=open_gop, codec=codec)
    if frame_pts is None:
        for frame in frames:
            enc.feed(frame)
    else:
        for frame, p in zip(frames, frame_pts, strict=True):
            enc.feed(frame, pts=np.asarray([p], np.int64))
    enc.flush()
    data, sizes, keys, pts, dts = enc.take_packets()
    lib.write_mp4(path, width, height, fps, enc.descriptor, enc.extradata,
                  data, sizes, keys, pts, dts)
    enc.close()


def synthesize_video(path: str, num_frames: int = 90, width: int = 128,
                     height: int = 96, fps: float = 24.0,
                     keyint: int = 12, bframes: int = 0,
                     open_gop: bool = False, frame_pts=None) -> None:
    """Encode a deterministic test clip to an .mp4 with libx264."""
    encode_frames_mp4(
        path, (frame_pattern(i, height, width) for i in range(num_frames)),
        width, height, fps=fps, keyint=keyint, bframes=bframes,
        open_gop=open_gop, frame_pts=frame_pts)
