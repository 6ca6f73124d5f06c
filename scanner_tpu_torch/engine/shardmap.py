"""Horizontally sharded control plane: the versioned shard map
(docs/robustness.md §Sharded control plane).

One Scanner cluster can run M master *shards* instead of one master.
Bulks (and all their durable control-plane state — generation claims,
checkpoints, journals) partition across shards by consistent hash on
the admission token, so each shard is exactly the single-master
control plane of engine/journal.py, scoped to a namespace
(`jobs/s<shard>/...`; shard 0 keeps the legacy unprefixed layout).
Losing a shard loses nothing: a respawned master for that shard
CAS-claims the next generation *in that shard's namespace* and
`_recover_bulk` + journal replay carry over verbatim as shard
failover.

This module owns the three pieces every other layer shares:

**The ring** — `ShardMap.shard_for(key)` maps a job token onto a
shard by consistent hash over ``VNODES`` virtual points per shard,
using a *stable* digest (md5), never Python's per-process randomized
``hash()``.  Removing a dead shard's points moves only the keys that
shard owned; every other shard's assignment is untouched — the
property tests/test_shardmap.py pins.

**The durable map** — each shard publishes its address into
``jobs/shardmap/e<epoch>.bin`` via `write_exclusive` CAS
(`register_shard`); highest epoch wins, losers re-merge and retry.
Every shard serves the map over the ``GetShardMap`` RPC; clients and
workers resolve it from any shard.  The **map epoch** fences routing:
mutating RPCs may stamp the epoch of the map they routed with, and a
master whose map is newer NACKs them (``{"stale_map": True}``) so a
stale map can never route a mutation past a failover.

**The series** — every ``scanner_tpu_shard_*`` metric (and the RPC
coalescing counter the per-shard fan-out makes necessary) registers
here; SHARD_SERIES names them for scanner-check SC316, which keeps
this tuple, the registrations, and the docs/observability.md catalog
table in sync, all directions.

Sizing: ``[control] shards`` / ``SCANNER_TPU_CONTROL_SHARDS`` (env
wins, read at import).  The default of 1 is the pre-sharding cluster,
bit-for-bit: shard 0 uses the legacy paths and no map is published.
"""

from __future__ import annotations

import bisect
import hashlib
import os
import threading
from typing import Dict, List, Optional

from ..storage import metadata as md
from ..storage.backend import StorageBackend
from ..util import metrics as _mx
from ..util.log import get_logger

_log = get_logger("shardmap")

# the [control] config keys this module accepts (scanner-check SC316
# keeps config.default_config() and this tuple in sync, both ways)
CONFIG_KEYS = ("shards",)

# virtual points per shard on the hash ring: enough that keys spread
# within a few percent of uniform across single-digit shard counts
VNODES = 64

# every shard-control-plane series, registered below in this module;
# scanner-check SC316 pairs this tuple with the registrations and the
# docs/observability.md shard-series table, both directions
SHARD_SERIES = (
    "scanner_tpu_shard_id",
    "scanner_tpu_shard_count",
    "scanner_tpu_shard_map_epoch",
    "scanner_tpu_shard_stale_map_rejections_total",
    "scanner_tpu_shard_failovers_total",
    "scanner_tpu_shard_journal_reexec_total",
    "scanner_tpu_rpc_coalesced_total",
)

_M_SHARD_ID = _mx.registry().gauge(
    "scanner_tpu_shard_id",
    "This master's shard id within the sharded control plane (0 in "
    "the default single-master deployment).")
_M_SHARD_COUNT = _mx.registry().gauge(
    "scanner_tpu_shard_count",
    "Number of master shards the control plane is configured for "
    "([control] shards / SCANNER_TPU_CONTROL_SHARDS).")
_M_MAP_EPOCH = _mx.registry().gauge(
    "scanner_tpu_shard_map_epoch",
    "Epoch of the newest shard map this process has observed — the "
    "fence a stale map's mutations are NACKed against.")
_M_STALE_MAP = _mx.registry().counter(
    "scanner_tpu_shard_stale_map_rejections_total",
    "Mutating RPCs NACKed because the caller routed with a shard map "
    "older than the serving master's (the stale-map fence; the caller "
    "refreshes the map and re-routes).")
_M_FAILOVERS = _mx.registry().counter(
    "scanner_tpu_shard_failovers_total",
    "Shard failovers completed by this master: recoveries that "
    "adopted a predecessor generation's bulk in a sharded "
    "(num_shards > 1) control plane.")
_M_REEXEC = _mx.registry().counter(
    "scanner_tpu_shard_journal_reexec_total",
    "Journaled-done tasks a recovery re-queued anyway — acknowledged "
    "completions that would re-execute.  Zero by construction; the "
    "master-shard-loss chaos drill asserts it stays zero.")
_M_COALESCED = _mx.registry().counter(
    "scanner_tpu_rpc_coalesced_total",
    "Control RPCs saved by coalescing: FinishedWork completions "
    "folded into a FinishedWorkBatch, and full heartbeat payloads "
    "folded into slim liveness beats on non-active shards.",
    labels=["method"])


def _flag_int(v: Optional[str], default: int) -> int:
    if v is None or v == "":
        return default
    return int(v)


_num_shards = max(1, _flag_int(os.environ.get("SCANNER_TPU_CONTROL_SHARDS"), 1))


def num_shards() -> int:
    return _num_shards


def set_num_shards(n: int) -> None:
    """Deployment default ([control] shards); the
    SCANNER_TPU_CONTROL_SHARDS env var is read at import and wins."""
    global _num_shards
    _num_shards = max(1, int(n))


def stable_hash(key: str) -> int:
    """Process-stable 64-bit digest (md5 prefix).  Never Python's
    ``hash()``: that is salted per process, and the ring must agree
    across every client, worker, and master."""
    return int.from_bytes(
        hashlib.md5(str(key).encode("utf-8")).digest()[:8], "big")


class ShardMap:
    """One immutable version of the shard membership: ``epoch`` plus
    ``{shard_id: address}``.  Routing hashes onto the ring built from
    the shards *present* — a dead shard's entry is simply absent in
    the successor epoch until its replacement re-registers, and only
    its keys move."""

    def __init__(self, epoch: int = 0,
                 shards: Optional[Dict[int, str]] = None,
                 num_shards: Optional[int] = None):
        self.epoch = int(epoch)
        self.shards: Dict[int, str] = {
            int(k): str(v) for k, v in (shards or {}).items()}
        self.num_shards = int(
            num_shards if num_shards is not None
            else (max(self.shards) + 1 if self.shards else 1))
        self._ring_keys: List[int] = []
        self._ring_sids: List[int] = []
        pts = []
        for sid in self.shards:
            for v in range(VNODES):
                pts.append((stable_hash(f"shard{sid}#{v}"), sid))
        pts.sort()
        self._ring_keys = [p[0] for p in pts]
        self._ring_sids = [p[1] for p in pts]

    def shard_for(self, key: str) -> int:
        """Owning shard id for a routing key (admission token / job
        id).  Empty map routes to shard 0 (the legacy master)."""
        if not self._ring_keys:
            return 0
        i = bisect.bisect_right(self._ring_keys, stable_hash(key))
        if i >= len(self._ring_keys):
            i = 0
        return self._ring_sids[i]

    def address_of(self, shard_id: int) -> Optional[str]:
        return self.shards.get(int(shard_id))

    def shard_ids(self) -> List[int]:
        return sorted(self.shards)

    def to_dict(self) -> dict:
        return {"epoch": self.epoch, "num_shards": self.num_shards,
                "shards": {str(k): v for k, v in self.shards.items()}}

    @classmethod
    def from_dict(cls, d: dict) -> "ShardMap":
        return cls(epoch=int(d.get("epoch", 0)),
                   shards={int(k): v
                           for k, v in (d.get("shards") or {}).items()},
                   num_shards=d.get("num_shards"))


# ---------------------------------------------------------------------------
# the durable map (CAS-published epochs on the storage backend)
# ---------------------------------------------------------------------------

# epochs below (newest - KEEP_EPOCHS) are pruned best-effort after a
# successful publish; enough history that a reader racing a publish
# never finds its epoch deleted mid-read
KEEP_EPOCHS = 8


def load(backend: StorageBackend) -> Optional[ShardMap]:
    """The newest published shard map, or None (unsharded db)."""
    best_epoch = -1
    best_path = None
    for p in backend.list_prefix(md.shardmap_prefix()):
        base = p.rsplit("/", 1)[-1]
        try:
            e = int(base.lstrip("e").split(".")[0])
        except ValueError:
            continue
        if e > best_epoch:
            best_epoch, best_path = e, p
    if best_path is None:
        return None
    try:
        return ShardMap.from_dict(md.unpack(backend.read(best_path)))
    except Exception:  # noqa: BLE001 — racing a prune, or torn write
        _log.warning("unreadable shard map at %s", best_path)
        return None


def publish(backend: StorageBackend, smap: ShardMap) -> bool:
    """CAS-publish one specific epoch: True for exactly one concurrent
    publisher (write_exclusive), False for the rest."""
    return backend.write_exclusive(
        md.shardmap_path(smap.epoch), md.pack(smap.to_dict()))


def register_shard(backend: StorageBackend, shard_id: int,
                   address: str, num_shards: int) -> ShardMap:
    """Merge this shard's address into the durable map at the next
    epoch (retrying the CAS until we win), and return the map
    published.  Startup AND failover use this: a respawned shard
    re-publishing its (possibly new) address is exactly the epoch bump
    that tells every map holder to refresh."""
    while True:
        cur = load(backend)
        shards = dict(cur.shards) if cur else {}
        shards[int(shard_id)] = str(address)
        nxt = ShardMap(epoch=(cur.epoch if cur else 0) + 1,
                       shards=shards, num_shards=num_shards)
        if publish(backend, nxt):
            _prune(backend, nxt.epoch)
            _log.info("published shard map epoch %d: shard %d -> %s",
                      nxt.epoch, shard_id, address)
            return nxt
        # lost the CAS race: another shard registered concurrently;
        # re-load so its entry survives the merge, take the next epoch


def _prune(backend: StorageBackend, newest: int) -> None:
    try:
        for p in backend.list_prefix(md.shardmap_prefix()):
            base = p.rsplit("/", 1)[-1]
            try:
                e = int(base.lstrip("e").split(".")[0])
            except ValueError:
                continue
            if e <= newest - KEEP_EPOCHS:
                backend.delete(p)
    except Exception:  # noqa: BLE001 — pruning is best-effort
        pass


# ---------------------------------------------------------------------------
# metric hooks (the one place the shard series are touched from)
# ---------------------------------------------------------------------------

def note_identity(shard_id: int, num_shards_: int) -> None:
    _M_SHARD_ID.set(int(shard_id))
    _M_SHARD_COUNT.set(int(num_shards_))


def note_map_epoch(epoch: int) -> None:
    _M_MAP_EPOCH.set(int(epoch))


def count_stale_map_rejection() -> None:
    _M_STALE_MAP.inc()


def count_failover() -> None:
    _M_FAILOVERS.inc()


def count_journal_reexec(n: int) -> None:
    if n:
        _M_REEXEC.inc(int(n))


def count_coalesced(method: str, n: int = 1) -> None:
    if n > 0:
        _M_COALESCED.labels(method=method).inc(int(n))


class MapHolder:
    """Thread-safe 'newest map I have seen' cell shared by a worker's
    heartbeat and pull loops (and the client's admission/poll loops).
    ``observe`` adopts strictly newer epochs only."""

    def __init__(self, smap: Optional[ShardMap] = None):
        self._lock = threading.Lock()
        self._map = smap

    def get(self) -> Optional[ShardMap]:
        with self._lock:
            return self._map

    def epoch(self) -> int:
        with self._lock:
            return self._map.epoch if self._map else 0

    def observe(self, smap: Optional[ShardMap]) -> bool:
        """Adopt a newer map; True when it replaced the held one."""
        if smap is None:
            return False
        with self._lock:
            if self._map is None or smap.epoch > self._map.epoch:
                self._map = smap
                return True
        return False
