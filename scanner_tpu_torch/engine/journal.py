"""Durable control plane: write-ahead bulk journal + master generation
fencing (docs/robustness.md §Durable control plane).

Two halves, both built on the storage backend the cluster already
shares (no new dependency, works on posix/GCS/memory alike):

**Write-ahead bulk journal** (`BulkJournal`) — between periodic
checkpoints the master appends every task-completion / strike /
blacklist / commit / admission / gang-lifecycle event as a checksummed
record into
rotated segment objects under the master's generation directory
(`jobs/g<gen>/journal/seg_*.bin`).  A completion is acknowledged to
the worker only after its record is durable, so a `kill -9` mid-bulk
loses **zero** acknowledged completions — recovery is checkpoint +
journal replay instead of a lossy checkpoint window.  Replay is
idempotent (done-sets union, failure counts carry their cumulative
value) so a record that raced a snapshot can be applied twice safely,
and a torn tail record — a crash mid-append on a non-atomic backend —
is tolerated: the complete prefix replays, the tail is dropped with a
warning.  Each checkpoint `cut()`s the journal and deletes the
segments the snapshot covers (compaction), bounding replay work to one
checkpoint window.

**Generation fencing** — a master claims a monotonic generation at
startup via `write_exclusive` CAS on a per-generation marker object
(`claim_generation`; exactly one concurrent claimant wins any given
generation).  Checkpoint/journal paths are generation-scoped, so a
paused-then-resumed stale master's late writes land in a directory its
successor never reads; every mutating control RPC reply is stamped
with the serving master's generation, workers latch the highest
generation they have seen (`GenerationLatch`) and NACK
assignments/revocations stamped with an older one, and a master that
observes a newer claim fences itself (mutating RPCs answer
`{"fenced": True}`, persistence stops).

Kill switch: ``SCANNER_TPU_JOURNAL=0`` / ``[robustness]
journal_enabled`` restores the pre-journal (checkpoint-window)
recovery; fencing is always on (one storage CAS at master startup).
``SCANNER_TPU_MASTER_GENERATION`` attaches a master at a forced
generation WITHOUT claiming — the stale-master lever chaos drills use;
never set it in production.
"""

from __future__ import annotations

import os
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..common import StorageException
from ..storage import metadata as md
from ..storage.backend import StorageBackend
from ..storage.items import (ItemCorruptionError, checksum_blob,
                             open_blob, verify_blob_checksum)
from ..util import metrics as _mx
from ..util.log import get_logger

_log = get_logger("journal")

# the [robustness] config keys this module accepts (scanner-check SC312
# keeps config.default_config() and this tuple in sync, both ways)
CONFIG_KEYS = ("journal_enabled", "journal_rotate_records")

# admission tokens the master remembers for NewJob dedupe (bounded: a
# token outlives its bulk only until 64 newer admissions displaced it)
TOKEN_RING = 64

# record types the master's recovery replay understands (engine/
# service.py _apply_journal_records).  The gang pair journals gang-in-
# flight state — `gang` at formation, `gang_abort` at teardown — whose
# replay restores the (gang_id, epoch) fence's high-water mark across
# a master failover: the successor's first formation mints a strictly
# higher epoch, so a pre-failover gang's late completion NACKs instead
# of double-committing (docs/robustness.md §Gang scheduling).
RECORD_TYPES = ("admit", "done", "strike", "transient", "blacklist",
                "commit", "gang", "gang_abort")


def gang_epoch_high_water(records) -> int:
    """Highest gang epoch any journaled gang record carries (0 when
    none) — the floor a recovering master's next formation must mint
    above.  Tooling/test twin of the in-recovery fold."""
    high = 0
    for r in records:
        if isinstance(r, dict) and r.get("t") in ("gang", "gang_abort"):
            high = max(high, int(r.get("e", 0) or 0))
    return high

_M_GENERATION = _mx.registry().gauge(
    "scanner_tpu_master_generation",
    "The monotonic master generation this process claimed (or attached "
    "to) at startup — the fencing epoch every mutating control RPC is "
    "stamped with (docs/robustness.md §Durable control plane).")
_M_APPENDS = _mx.registry().counter(
    "scanner_tpu_journal_appends_total",
    "Records appended to the write-ahead bulk journal (task "
    "completions, strikes, blacklists, commits, admissions).")
_M_BYTES = _mx.registry().counter(
    "scanner_tpu_journal_bytes_total",
    "Encoded bytes appended to the write-ahead bulk journal.")
_M_REPLAYED = _mx.registry().counter(
    "scanner_tpu_journal_replayed_records_total",
    "Journal records replayed over the checkpoint during bulk "
    "recovery — completions a plain checkpoint-window restart would "
    "have lost and re-executed.")
_M_STALE = _mx.registry().counter(
    "scanner_tpu_stale_master_rejections_total",
    "Mutations rejected on generation-fence grounds: side=worker "
    "counts stale-generation master replies a worker NACKed, "
    "side=master counts mutating RPCs a fenced (superseded) master "
    "refused.", labels=["side"])


def _flag(v: Optional[str], default: bool) -> bool:
    if v is None or v == "":
        return default
    return v.strip().lower() not in ("0", "false", "no", "off")


_enabled = _flag(os.environ.get("SCANNER_TPU_JOURNAL"), True)
_rotate_records = int(
    os.environ.get("SCANNER_TPU_JOURNAL_ROTATE", "") or 256)


def enabled() -> bool:
    return _enabled


def set_enabled(on: bool) -> None:
    """Deployment default ([robustness] journal_enabled); the
    SCANNER_TPU_JOURNAL env var is read at import and wins."""
    global _enabled
    _enabled = bool(on)


def rotate_records() -> int:
    return _rotate_records


def set_rotate_records(n: int) -> None:
    global _rotate_records
    _rotate_records = max(1, int(n))


# ---------------------------------------------------------------------------
# master generation claims (CAS on the storage backend)
# ---------------------------------------------------------------------------

def try_claim(backend: StorageBackend, gen: int,
              note: str = "", shard: int = 0) -> bool:
    """Atomically claim one specific generation: True for exactly one
    concurrent claimant (write_exclusive CAS), False for the rest.
    Claims are scoped per control-plane shard (storage/metadata.py
    shard_prefix) — shards fence independently."""
    payload = md.pack({"generation": gen, "pid": os.getpid(),
                       "time": time.time(), "note": note,
                       "shard": int(shard)})
    return backend.write_exclusive(md.generation_path(gen, shard),
                                   payload)


def claimed_generations(backend: StorageBackend,
                        shard: int = 0) -> List[int]:
    out = []
    for p in backend.list_prefix(md.generation_prefix(shard)):
        base = p.rsplit("/", 1)[-1]
        try:
            out.append(int(base.split(".")[0]))
        except ValueError:
            continue
    return sorted(out)


def highest_claimed(backend: StorageBackend, shard: int = 0) -> int:
    gens = claimed_generations(backend, shard)
    return gens[-1] if gens else 0


def claim_generation(backend: StorageBackend, note: str = "",
                     shard: int = 0) -> int:
    """Claim the next free generation (monotonic; a successor always
    outranks every predecessor on the same db + shard).  The
    SCANNER_TPU_MASTER_GENERATION env var attaches at a forced
    generation WITHOUT claiming — the stale-master chaos lever."""
    forced = os.environ.get("SCANNER_TPU_MASTER_GENERATION")
    if forced:
        gen = int(forced)
        _log.warning("attached at forced master generation %d (no "
                     "claim; SCANNER_TPU_MASTER_GENERATION)", gen)
        _M_GENERATION.set(gen)
        return gen
    gen = highest_claimed(backend, shard)
    while True:
        gen += 1
        if try_claim(backend, gen, note=note, shard=shard):
            _M_GENERATION.set(gen)
            _log.info("claimed master generation %d (shard %d)",
                      gen, shard)
            return gen
        # lost the CAS race for this generation: someone else is also
        # starting up; take the next slot (latest claim outranks)


class GenerationLatch:
    """Worker-side fence: latch the highest master generation seen on
    any reply; a reply stamped with an older generation is a stale
    master's — its assignments/revocations are NACKed."""

    def __init__(self) -> None:
        self._highest = 0
        self._lock = threading.Lock()

    def highest(self) -> int:
        with self._lock:
            return self._highest

    def observe(self, reply: Optional[dict]) -> bool:
        """True when the reply may be acted on; False (counted) when it
        came from a stale (superseded) master generation.  Replies
        with no generation stamp (legacy masters) always pass."""
        if not isinstance(reply, dict):
            return True
        gen = reply.get("generation")
        if gen is None:
            return True
        gen = int(gen)
        with self._lock:
            if gen >= self._highest:
                self._highest = gen
                return True
        _M_STALE.labels(side="worker").inc()
        _log.warning("NACKing reply from stale master generation %d "
                     "(highest seen: %d)", gen, self.highest())
        return False


# ---------------------------------------------------------------------------
# record framing
# ---------------------------------------------------------------------------

# per-record frame: payload length, checksum-algorithm version (the
# items.py crc32c/zlib marker), crc over the payload.  Records carry
# their own checksum so a torn tail is detected per record, not per
# segment.
_REC_HDR = struct.Struct("<III")


def encode_record(rec: dict) -> bytes:
    payload = md.pack(rec)
    version, crc = checksum_blob(payload)
    return _REC_HDR.pack(len(payload), version, crc) + payload


def decode_segment(data: bytes, path: str = "",
                   tolerate_tail: bool = True
                   ) -> Tuple[List[dict], Optional[str]]:
    """Parse one segment's records.  Returns (records, problem): a torn
    tail record (truncated frame, or a checksum failure on the FINAL
    record while tolerate_tail) yields the complete prefix with
    problem="torn"; a mid-stream corruption stops parsing with
    problem="corrupt" (records after it are unknowable)."""
    out: List[dict] = []
    off = 0
    n = len(data)
    while off < n:
        if n - off < _REC_HDR.size:
            return out, "torn"
        length, version, crc = _REC_HDR.unpack_from(data, off)
        start = off + _REC_HDR.size
        if n - start < length:
            return out, "torn"
        payload = data[start:start + length]
        try:
            verify_blob_checksum(version, crc, payload, path)
            rec = md.unpack(payload)
        except ItemCorruptionError:
            # checksum failure on the very last record = a torn tail
            # in disguise (partial overwrite); anywhere else = real
            # corruption — stop, later records' framing is untrusted
            if tolerate_tail and start + length >= n:
                return out, "torn"
            return out, "corrupt"
        except Exception:  # noqa: BLE001 — undecodable payload
            return out, "corrupt"
        if isinstance(rec, dict):
            out.append(rec)
        off = start + length
    return out, None


# ---------------------------------------------------------------------------
# the write-ahead bulk journal
# ---------------------------------------------------------------------------

class BulkJournal:
    """Rotated, checksummed event segments for the active bulk.

    The storage backends are whole-blob stores (no append primitive),
    so the open segment is rewritten atomically on every append —
    bounded by `rotate_records`, after which the segment seals and a
    new one opens.  `append()` is durable on return: callers ack their
    RPC only after it."""

    def __init__(self, backend: StorageBackend, generation: int,
                 rotate: Optional[int] = None, shard: int = 0):
        self.backend = backend
        self.generation = generation
        self.shard = int(shard)
        self.rotate = int(rotate or rotate_records())
        self._lock = threading.Lock()
        self._seg = 0
        self._buf: List[bytes] = []
        # third-party backends may predate the sync= kwarg: probe once
        import inspect
        try:
            self._sync_kw = "sync" in inspect.signature(
                backend.write).parameters
        except (TypeError, ValueError):
            self._sync_kw = False

    def append(self, *records: dict) -> None:
        """Durably append records (group-committed under one write)."""
        if not records:
            return
        encoded = [encode_record(r) for r in records]
        with self._lock:
            self._buf.extend(encoded)
            path = md.journal_segment_path(self.generation, self._seg,
                                           self.shard)
            # group-commit serialization by design: concurrent
            # appenders queue on this lock and each write carries every
            # record buffered so far; the open segment must be
            # rewritten whole for the frame sequence to stay parseable.
            # sync=False: process-kill durability only needs the page
            # cache, and the frame format tolerates the torn tail a
            # machine crash could leave — one fsync per acknowledged
            # completion would dominate master throughput otherwise.
            blob = b"".join(self._buf)
            if self._sync_kw:
                self.backend.write(path, blob, sync=False)  # scanner-check: disable=SC202 group-commit WAL write; appenders must serialize on the open segment
            else:
                self.backend.write(path, blob)  # scanner-check: disable=SC202 group-commit WAL write (legacy backend, no sync=)
            _M_APPENDS.inc(len(encoded))
            _M_BYTES.inc(sum(len(e) for e in encoded))
            if len(self._buf) >= self.rotate:
                self._seg += 1
                self._buf = []

    def cut(self) -> int:
        """Seal the open segment; every record appended before this
        call lives in a segment below the returned index, every record
        appended after it lands at or above.  Call while holding the
        state lock the journaled mutations happen under — then a
        snapshot taken at the same point covers exactly the sealed
        segments, and `compact_below(cut)` is safe."""
        with self._lock:
            if self._buf:
                self._seg += 1
                self._buf = []
            return self._seg

    def compact_below(self, seg: int) -> None:
        """Delete sealed segments a checkpoint now covers."""
        for path in self.backend.list_prefix(
                md.journal_dir(self.generation, self.shard)):
            base = path.rsplit("/", 1)[-1]
            try:
                idx = int(base.split("_")[-1].split(".")[0])
            except ValueError:
                continue
            if idx < seg:
                self.backend.delete(path)

    def reset(self) -> None:
        """Start over for a new bulk: drop every segment of this
        generation and rewind to segment 0."""
        with self._lock:
            self.backend.delete_prefix(  # scanner-check: disable=SC202 bulk boundary only (admission/clear), not a hot path
                md.journal_dir(self.generation, self.shard))
            self._seg = 0
            self._buf = []


def replay(backend: StorageBackend, generation: int, shard: int = 0
           ) -> Tuple[List[dict], Dict[str, int]]:
    """Read every surviving record of one generation's journal, in
    order.  A torn tail on the final segment is tolerated (warned); a
    mid-journal corruption stops replay there at ERROR — the prefix is
    still applied, everything after it is unknowable."""
    paths = sorted(backend.list_prefix(md.journal_dir(generation,
                                                      shard)))
    records: List[dict] = []
    stats = {"segments": len(paths), "records": 0, "torn": 0,
             "corrupt": 0}
    for i, path in enumerate(paths):
        last = i == len(paths) - 1
        data = backend.read(path)
        recs, problem = decode_segment(data, path=path,
                                       tolerate_tail=last)
        records.extend(recs)
        if problem == "torn":
            stats["torn"] += 1
            if last:
                _log.warning(
                    "journal %s has a torn tail record: replaying the "
                    "%d complete records before it", path, len(recs))
            else:
                # a truncated NON-final segment means later segments'
                # records may depend on lost ones — same verdict as
                # corruption
                stats["corrupt"] += 1
                _log.error(
                    "journal %s is truncated mid-stream: stopping "
                    "replay at %d records", path, len(records))
                break
        elif problem == "corrupt":
            stats["corrupt"] += 1
            _log.error(
                "journal %s has a corrupt record: stopping replay at "
                "%d records (later records are untrusted)", path,
                len(records))
            break
    stats["records"] = len(records)
    if records:
        _M_REPLAYED.inc(len(records))
    return records, stats


def read_control_blob(backend: StorageBackend, path: str,
                      what: str = "control blob") -> Optional[bytes]:
    """Read a (possibly legacy-unsealed) control-plane blob.  Returns
    its payload, or None — logged at ERROR — when the blob fails its
    checksum: callers fall back to journal replay instead of silently
    resurrecting garbage.  The one shared seal/legacy/corruption
    policy for the master's recovery AND tooling/tests."""
    if not backend.exists(path):
        return None
    raw = backend.read(path)
    try:
        return open_blob(raw, path)
    except ItemCorruptionError:
        _log.error("%s at %s failed its checksum: falling back to "
                   "journal replay", what, path)
        return None
    except StorageException:
        # no sealed-blob magic: a legacy (pre-checksum) write
        return raw


def load_bulk_progress(backend: StorageBackend,
                       shard: int = 0) -> Optional[dict]:
    """The newest generation's persisted bulk-progress snapshot
    (crc-verified; legacy unsealed files still load), or None.  A
    tooling/test helper — the master's own recovery path lives in
    engine/service.py."""
    import cloudpickle

    gens = sorted(claimed_generations(backend, shard), reverse=True)
    for g in gens + [None]:
        payload = read_control_blob(backend,
                                    md.bulk_progress_path(g, shard),
                                    what="bulk progress")
        if payload is None:
            continue
        try:
            return cloudpickle.loads(payload)
        except Exception:  # noqa: BLE001 — undecodable snapshot
            continue
    return None


def count_stale_rejection(side: str) -> None:
    """Shared counter hook for fence rejections (side=master|worker)."""
    _M_STALE.labels(side=side).inc()


def set_generation_gauge(gen: int) -> None:
    _M_GENERATION.set(gen)
