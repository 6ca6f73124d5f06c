"""Paged per-device frame cache with cross-task reuse.

The port of the JAX package's ``scanner_tpu/engine/framecache.py``.
Minimal-decode scheduling still re-pays decode + host->device copy for
bytes already on the right card: overlapping stencil windows re-decode
their back-reach rows, Gather samplings re-decode the hot clip, and a
second pipeline over the same table starts from scratch.  This module
is the fix — a per-device paged frame pool in the spirit of Ragged
Paged Attention's paged KV cache: decoded frames live in fixed-size,
keyframe-aligned pages (tensors on the task's device) keyed by
``(table, column, item, wire format, page)`` *per device*, the loader
consults the pool before planning decode and only decodes the miss
ranges, and staging becomes a page-table gather on the task's device
instead of a fresh host->device copy.

Design points:

  * **Pages are GOP-decodable units.**  The page size is a multiple of
    the stream's keyframe interval (auto-derived; ``set_page_frames``
    pins it), aligned to the item start, so a page never needs packets
    outside its own keyframe runs.  The tail page of an item is short.
  * **No extra decode, no extra h2d.**  The pool never widens a task's
    decode, and page fills ride the very device blocks the task stages
    for itself: a completed page is an ON-DEVICE concatenate of
    retained fragments copied out of the staged blocks (``_fill``
    buffers, bounded LRU), so a cold cache-on run ships exactly the
    bytes a cache-off run would.  Fragments and pages own their storage
    (``clone`` / ``torch.cat``): a view would pin the whole staged
    block, bill the ledger the wrong bytes, and alias memory the loader
    frees.
  * **LRU with in-flight pinning.**  ``plan()`` pins every page a task
    will gather from; the executor releases the lease when evaluation
    finishes (with a ``weakref.finalize`` backstop on the TaskItem), so
    eviction can never "free" bytes an in-flight dispatch still
    references.  Eviction takes the oldest unpinned page; an all-pinned
    pool may transiently overshoot its target rather than corrupt a
    task.
  * **Byte-accurate accounting.**  Every page registers in the
    allocation ledger (``memstats.track_array``, kind=``cache``), page
    staging counts into the same ``scanner_tpu_h2d_*`` series direct
    staging does (so a cache-on/off A/B compares like for like), and a
    firing ``hbm_pressure`` alert shrinks the capacity target and
    evicts down *before* OOM strikes a task
    (``scanner_tpu_framecache_pressure_shrinks_total``, through the
    controller's ``frame_cache_shrink`` playbook).

``SCANNER_TPU_FRAME_CACHE=0`` is the kill switch / A/B lever;
``SCANNER_TPU_FRAME_CACHE_MB`` overrides the per-device capacity.
"""

from __future__ import annotations

import os
import threading
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..util import faults as _faults
from ..util import memstats as _ms
from ..util import metrics as _mx
from ..util import tracing as _tracing
from ..util.log import get_logger

_log = get_logger("framecache")

_M_HITS = _mx.registry().counter(
    "scanner_tpu_framecache_hits_total",
    "Frames served from resident frame-cache pages instead of decode + "
    "host->device staging, per device.",
    labels=["device"])
_M_MISSES = _mx.registry().counter(
    "scanner_tpu_framecache_misses_total",
    "Frames a cache-consulting load still had to decode (page absent "
    "or not yet filled), per device.",
    labels=["device"])
_M_INSERTS = _mx.registry().counter(
    "scanner_tpu_framecache_inserts_total",
    "Frame-cache pages staged to device and inserted, per device.",
    labels=["device"])
_M_EVICTIONS = _mx.registry().counter(
    "scanner_tpu_framecache_evictions_total",
    "Frame-cache pages evicted (LRU capacity eviction or pressure "
    "shrink), per device.",
    labels=["device"])
_M_PINNED = _mx.registry().gauge(
    "scanner_tpu_framecache_pinned_bytes",
    "Bytes of frame-cache pages currently pinned by in-flight tasks "
    "(ineligible for eviction), per device.",
    labels=["device"])
_M_LIVE = _mx.registry().gauge(
    "scanner_tpu_framecache_live_bytes",
    "Bytes of resident frame-cache pages, per device (also visible as "
    "ledger kind=cache in the scanner_tpu_ledger_* series).",
    labels=["device"])
_M_CAPACITY = _mx.registry().gauge(
    "scanner_tpu_framecache_capacity_bytes",
    "Current frame-cache capacity target per device (config/env "
    "default, lowered by hbm_pressure shrinks).",
    labels=["device"])
_M_SHRINKS = _mx.registry().counter(
    "scanner_tpu_framecache_pressure_shrinks_total",
    "Capacity-target shrinks triggered by a firing hbm_pressure alert "
    "(the auto-remediation seed: evict down before OOM strikes a "
    "task), per device.",
    labels=["device"])


# -- knobs ------------------------------------------------------------------

# same env semantics as SCANNER_TPU_MEMSTATS (one parser, no drift);
# SCANNER_TPU_FRAME_CACHE=0 is the A/B kill switch
_ENABLED = _tracing._env_on("SCANNER_TPU_FRAME_CACHE")


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Programmatic override (tests, A/B runs); the
    SCANNER_TPU_FRAME_CACHE env var is read at import."""
    global _ENABLED
    _ENABLED = bool(on)


def _env_capacity_mb() -> Optional[int]:
    v = os.environ.get("SCANNER_TPU_FRAME_CACHE_MB", "")
    try:
        return max(1, int(v)) if v else None
    except ValueError:
        return None


DEFAULT_CAPACITY_MB = 256
_capacity_mb = _env_capacity_mb() or DEFAULT_CAPACITY_MB
# floor the pressure shrink can't go below: a page or two must always
# fit or the cache thrashes pointlessly at zero
MIN_CAPACITY_BYTES = 8 << 20


def set_capacity_mb(mb: int) -> None:
    """Set the per-device capacity; the SCANNER_TPU_FRAME_CACHE_MB env
    var (read at import) wins when set.  An explicit reconfigure also
    clears persisted pressure-shrink targets — the way to re-arm a
    device hbm_pressure capped."""
    global _capacity_mb
    if _env_capacity_mb() is None:
        _capacity_mb = max(1, int(mb))
        if _CACHE is not None:
            with _CACHE._lock:
                _CACHE._target.clear()


# 0 = auto: the smallest multiple of the stream's keyframe interval
# >= _PAGE_BASE frames, so pages land on GOP boundaries
_PAGE_BASE = 32
_page_frames_cfg = 0


def set_page_frames(n: int) -> None:
    """Pin the page size in frames (0 = auto, keyframe-aligned)."""
    global _page_frames_cfg
    _page_frames_cfg = max(0, int(n))


# fill buffers: pending (incomplete) pages retained at most; their
# fragments are device tensors billed against the pool's capacity
_MAX_FILL_PAGES = 64


# a member evaluating only rows [lo, hi) of every task tags its pages
# with its shard identity, so page keys are scoped under
# (host-shard, device) — a re-formed gang at a different num_processes
# (whose shard boundaries moved) can never gather a stale page built
# under the old layout, and residency per member is 1/N by construction
# (the shard plan only ever touches shard rows).  None = unsharded
# (the default single-host / replicated identity).
_HOST_SHARD: Optional[str] = None


def set_host_shard(tag: Optional[str]) -> None:
    """Scope this process's cache pages under a shard identity (sharded
    gang member children call this once before evaluating; pass None to
    clear)."""
    global _HOST_SHARD
    _HOST_SHARD = str(tag) if tag else None


def host_shard() -> Optional[str]:
    return _HOST_SHARD


# cache identity for a Database backend: (root, process-unique seq).
# The seq — minted once per backend OBJECT via a weak map — is what
# makes the key collision-proof: a database deleted and re-created at
# the same root restarts table ids at 0, and `id()` alone can be
# reused after collection.  The cost is that two Database objects over
# the same root do not share pages (one worker = one Database in
# practice).
_DB_KEYS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_DB_SEQ = [0]
_DB_KEY_LOCK = threading.Lock()


def db_cache_key(backend: Any) -> Tuple[Any, int]:
    root = getattr(backend, "root", None) or "mem"
    try:
        with _DB_KEY_LOCK:
            key = _DB_KEYS.get(backend)
            if key is None:
                _DB_SEQ[0] += 1
                key = (root, _DB_SEQ[0])
                _DB_KEYS[backend] = key
            return key
    except TypeError:  # un-weakref-able backend: fall back to identity
        return (root, id(backend))


def _runs(seq: List[int]):
    """Yield (lo, hi) index ranges of `seq` over which the VALUES are
    consecutive integers (maximal runs)."""
    i = 0
    while i < len(seq):
        j = i + 1
        while j < len(seq) and seq[j] == seq[j - 1] + 1:
            j += 1
        yield i, j
        i = j


class CacheBypass(Exception):
    """The cache cannot serve this request (mixed page geometry after a
    table rewrite mid-flight); callers fall back to the direct decode +
    staging path — the cache is an optimization only."""


# -- internal structures ----------------------------------------------------

# a page's identity:
# (device label, table key, column, item, fmt, page idx) — the table
# key is opaque (the executor passes (db root, table id))
PageKey = Tuple[Any, ...]


class _Page:
    __slots__ = ("key", "data", "start", "n", "nbytes", "pins", "hw")

    def __init__(self, key: PageKey, data: Any, start: int, n: int,
                 hw: Tuple[int, int]):
        self.key = key
        self.data = data            # tensor (n, ...) wire-format rows
        self.start = start          # first item-local row of the page
        self.n = n                  # rows resident (== page size or tail)
        self.nbytes = _nbytes(data)
        self.pins = 0
        self.hw = hw                # decoded (height, width) for convert


class Lease:
    """Pins a set of pages for the life of one task's dispatch; released
    by the executor when evaluation finishes (idempotent, thread-safe —
    a weakref.finalize on the owning TaskItem is the backstop for
    aborted pipelines)."""

    __slots__ = ("_cache", "_pages", "_released")

    def __init__(self, cache: "FrameCache"):
        self._cache = cache
        self._pages: List[_Page] = []
        self._released = False

    def release(self) -> None:
        self._cache._release_lease(self)


class Plan:
    """One cache consultation: which of a task's rows are resident (and
    now pinned), which must still be decoded."""

    __slots__ = ("device", "dev", "skey", "page_frames", "rows",
                 "total_rows", "hit_mask", "miss_rows", "lease", "hw")

    def __init__(self, device: Any, dev: str, skey: Tuple, page_frames: int,
                 rows: np.ndarray, total_rows: int, hit_mask: np.ndarray,
                 lease: Lease, hw: Optional[Tuple[int, int]]):
        self.device = device        # torch device (or None = the host)
        self.dev = dev              # its label
        self.skey = skey            # ([shard,] table_id, column, item, fmt)
        self.page_frames = page_frames
        self.rows = rows            # item-local, sorted
        self.total_rows = total_rows
        self.hit_mask = hit_mask    # bool per row
        self.miss_rows = rows[~hit_mask]
        self.lease = lease
        self.hw = hw                # (h, w) from a hit page, if any


class FrameCache:
    """The per-process pool.  One instance (``cache()``); per-device
    state inside, so chip 1's tasks can never gather chip 0's pages —
    the page key leads with the device label."""

    def __init__(self):
        # RLock, not Lock: lease release runs from weakref finalizers
        # (the TaskItem backstop), which the cyclic GC may fire at any
        # allocation point — including inside a locked plan/offer on
        # the SAME thread.  Lock-order rule (the memstats ledger's):
        # the finalizer path (_release_lease) touches ONLY this lock
        # and plain dict/int work, and NOTHING acquires a metrics
        # family/child lock while holding this one (_ensure_gauges and
        # every metric inc run strictly outside it).
        self._lock = threading.RLock()
        self._pages: "OrderedDict[PageKey, _Page]" = OrderedDict()
        # (dev, skey, page_idx) -> {local_row: (device block, offset)} —
        # pages complete from the DEVICE blocks assemble already staged
        # (an on-device concatenate), so filling a page never re-pays
        # h2d for rows the task shipped anyway
        self._fill: "OrderedDict[Tuple, Dict[int, Tuple[Any, int]]]" = \
            OrderedDict()
        # fill-fragment byte accounting: fragments are HBM too, so they
        # bill against the capacity target and evict (oldest first,
        # before any page — an incomplete page is the cheapest victim)
        self._fill_nbytes: Dict[Tuple, int] = {}
        self._fill_dev: Dict[str, int] = {}
        self._page_frames: Dict[Tuple, int] = {}   # per skey
        self._live: Dict[str, int] = {}
        self._pinned: Dict[str, int] = {}
        self._target: Dict[str, int] = {}          # capacity per device
        self._hits: Dict[str, int] = {}
        self._misses: Dict[str, int] = {}
        self._evictions: Dict[str, int] = {}
        self._inserts: Dict[str, int] = {}
        self._shrinks: Dict[str, int] = {}
        self._gauged: set = set()

    # -- gauges (scrape-time samplers, like the memstats ledger) --------

    def _ensure_gauges(self, dev: str) -> None:
        # only the process singleton may bind the process-global
        # gauges: a private instance (tests) would otherwise hijack the
        # samplers — and be kept alive forever by their closures
        if self is not _CACHE or dev in self._gauged:
            return
        self._gauged.add(dev)
        _M_LIVE.labels(device=dev).set_function(
            lambda d=dev: float(self._live.get(d, 0)))
        _M_PINNED.labels(device=dev).set_function(
            lambda d=dev: float(self._pinned.get(d, 0)))
        _M_CAPACITY.labels(device=dev).set_function(
            lambda d=dev: float(self._capacity(d)))

    def _capacity(self, dev: str) -> int:
        return self._target.get(dev, _capacity_mb << 20)

    # -- page math ------------------------------------------------------

    def _resolve_page_frames(self, skey: Tuple, keyint: int) -> int:
        pf = self._page_frames.get(skey)
        if pf is not None:
            return pf
        if _page_frames_cfg > 0:
            pf = _page_frames_cfg
        elif keyint and keyint > 1:
            # smallest keyint multiple >= _PAGE_BASE: pages are whole
            # GOPs, so filling one never needs foreign packets
            pf = keyint * max(1, -(-_PAGE_BASE // keyint))
        else:
            pf = _PAGE_BASE
        self._page_frames[skey] = pf
        return pf

    @staticmethod
    def _page_len(start: int, page_frames: int, total_rows: int) -> int:
        return min(page_frames, total_rows - start)

    # -- the loader-facing API ------------------------------------------

    def plan(self, device: Any, table: Any, column: str, item: int,
             fmt: str, rows: np.ndarray, total_rows: int,
             keyint: int = 0) -> Plan:
        """Consult the pool for a task's item-local `rows` on `device`:
        pins every resident page that covers one of them, counts
        hit/miss telemetry, and returns the plan whose ``miss_rows``
        the loader still decodes.  `table` is an opaque hashable source
        identity — the executor passes (db root, table id): ids are
        per-database and restart at 0, so the id alone would alias
        same-shaped tables of different databases in one process;
        recreated tables mint fresh ids, which is the staleness story."""
        dev = _ms.device_label(device)
        # page identity is (host-shard, device, table, column, item,
        # fmt, page): sharded gang members never share pages across
        # shard layouts (set_host_shard above)
        skey = (_HOST_SHARD, table, column, int(item), fmt) \
            if _HOST_SHARD else (table, column, int(item), fmt)
        rows = np.asarray(rows, np.int64)
        lease = Lease(self)
        hit = np.zeros(len(rows), bool)
        hw: Optional[Tuple[int, int]] = None
        with self._lock:
            pf = self._resolve_page_frames(skey, keyint)
            pinned: Dict[int, _Page] = {}
            for i, r in enumerate(rows.tolist()):
                pidx = r // pf
                page = pinned.get(pidx)
                if page is None:
                    key = (dev,) + skey + (pidx,)
                    page = self._pages.get(key)
                    if page is None:
                        continue
                    self._pages.move_to_end(key)
                    self._pin_locked(page, lease)
                    pinned[pidx] = page
                    hw = hw or page.hw
                # both bounds: a surviving page built under a DIFFERENT
                # page size (clear() keeps pinned pages but re-resolves
                # sizes) must never match a row below its start — a
                # negative gather index would wrap to the wrong frame
                if 0 <= r - page.start < page.n:
                    hit[i] = True
            n_hit = int(hit.sum())
            n_miss = len(rows) - n_hit
            self._hits[dev] = self._hits.get(dev, 0) + n_hit
            self._misses[dev] = self._misses.get(dev, 0) + n_miss
        # metric work strictly OUTSIDE the pool lock (lock-order rule
        # at self._lock)
        self._ensure_gauges(dev)
        if n_hit:
            _M_HITS.labels(device=dev).inc(n_hit)
            _tracing.add_event("cache.hit", device=dev, rows=n_hit)
        if n_miss:
            _M_MISSES.labels(device=dev).inc(n_miss)
            _tracing.add_event("cache.miss", device=dev, rows=n_miss)
        return Plan(device, dev, skey, pf, rows, int(total_rows), hit,
                    lease, hw)

    def _offer_block(self, plan: Plan, seg_rows: np.ndarray, block: Any,
                     hw: Optional[Tuple[int, int]]) -> None:
        """Feed one freshly staged device block (block[i] holds row
        seg_rows[i]) toward page completion.  A page whose every row is
        now covered builds by an ON-DEVICE concatenate of the retained
        blocks — filling the pool never re-pays h2d for rows the task
        staged anyway; incomplete pages buffer block references
        (bounded LRU) until later tasks complete them.  Best-effort:
        a failed page build only loses caching, never the task."""
        if not len(seg_rows):
            return
        pf = plan.page_frames
        # phase 1 (locked): which rows does each touched page still need
        claims: List[Tuple[Tuple, int, int, int, List[int]]] = []
        with self._lock:
            for pidx in np.unique(seg_rows // pf).tolist():
                start = int(pidx) * pf
                plen = self._page_len(start, pf, plan.total_rows)
                if plen <= 0:
                    continue
                fkey = (plan.dev,) + plan.skey + (int(pidx),)
                if fkey in self._pages:
                    continue
                have = self._fill.get(fkey) or ()
                sel = [pos for pos in np.flatnonzero(
                    (seg_rows >= start)
                    & (seg_rows < start + plen)).tolist()
                    if int(seg_rows[pos]) not in have]
                if sel:
                    claims.append((fkey, int(pidx), start, plen, sel))
        if not claims:
            return
        # phase 2 (UNLOCKED): the device fragment copies — holding the
        # process-wide pool lock across them would stall every other
        # loader's cache consultation.  Copying out of the task's block
        # matters: a slice is a view, and retaining it would pin the
        # whole task batch in device memory until the page completes
        # (and bill the ledger for bytes the cache does not own);
        # clone() gives each fragment storage of its own.
        staged: List[Tuple[Tuple, int, int, int,
                           Dict[int, Tuple[Any, int]]]] = []
        for fkey, pidx, start, plen, sel in claims:
            m: Dict[int, Tuple[Any, int]] = {}
            for lo, hi in _runs(sel):
                frag = block[sel[lo]:sel[hi - 1] + 1].clone()
                _ms.track_array(
                    frag, "cache",
                    device=plan.dev if plan.device is not None else None)
                for k in range(lo, hi):
                    m[int(seg_rows[sel[k]])] = (frag, k - lo)
            staged.append((fkey, pidx, start, plen, m))
        # phase 3 (locked): install fragments (setdefault — a racing
        # loader's duplicate copies are dropped and collected) + the
        # completion check
        complete: List[Tuple[int, int, Dict[int, Tuple[Any, int]]]] = []
        with self._lock:
            for fkey, pidx, start, plen, m in staged:
                if fkey in self._pages:
                    continue
                buf = self._fill.get(fkey)
                if buf is None:
                    buf = self._fill[fkey] = {}
                    while len(self._fill) > _MAX_FILL_PAGES:
                        self._drop_fill_locked(
                            next(iter(self._fill)))
                else:
                    self._fill.move_to_end(fkey)
                for r, v in m.items():
                    buf.setdefault(r, v)
                self._refresh_fill_bytes_locked(fkey, buf)
                if len(buf) == plen:
                    self._drop_fill_locked(fkey, keep=buf)
                    complete.append((pidx, start, buf))
            evicted = self._evict_down_locked(plan.dev)
        if evicted:
            # metric/trace work outside the lock, same as every other
            # eviction site — dashboards must see fill-pressure churn
            _M_EVICTIONS.labels(device=plan.dev).inc(evicted)
            _tracing.add_event("cache.evict", device=plan.dev,
                               pages=evicted)
        for pidx, start, buf in complete:
            self._build_page(plan, pidx, start, buf, hw)

    def _refresh_fill_bytes_locked(self, fkey: Tuple,
                                   buf: Dict[int, Tuple[Any, int]]
                                   ) -> None:
        new = sum(_nbytes(f) for f in
                  {id(f): f for f, _ in buf.values()}.values())
        old = self._fill_nbytes.get(fkey, 0)
        self._fill_nbytes[fkey] = new
        dev = fkey[0]
        self._fill_dev[dev] = self._fill_dev.get(dev, 0) + new - old

    def _drop_fill_locked(self, fkey: Tuple, keep=None) -> None:
        """Remove one fill buffer and its byte accounting (`keep` =
        the buffer is graduating to a page build, not being
        discarded — the caller already holds it)."""
        buf = self._fill.pop(fkey, None)
        old = self._fill_nbytes.pop(fkey, 0)
        if buf is not None or keep is not None:
            dev = fkey[0]
            self._fill_dev[dev] = max(
                self._fill_dev.get(dev, 0) - old, 0)

    def _build_page(self, plan: Plan, pidx: int, start: int,
                    buf: Dict[int, Tuple[Any, int]],
                    hw: Optional[Tuple[int, int]]) -> None:
        """Concatenate a completed page's device blocks (runs of
        consecutive offsets in one block become a single slice) and
        insert it, evicting LRU unpinned pages past the capacity
        target."""
        key = (plan.dev,) + plan.skey + (pidx,)
        try:
            if _faults.ACTIVE:
                # the chaos site for the fill path: an injected device
                # OOM here is ABSORBED (the cache degrades, the task
                # proceeds) — detail leads "cache" so plans can target
                # it apart from argument staging
                _faults.inject("memory.pressure",
                               detail=f"cache page {plan.dev} p{pidx}")
            rows = sorted(buf)
            parts = []
            i = 0
            while i < len(rows):
                frag, off = buf[rows[i]]
                j = i + 1
                while j < len(rows):
                    f2, o2 = buf[rows[j]]
                    if f2 is not frag or o2 != off + (j - i):
                        break
                    j += 1
                if off == 0 and j - i == int(frag.shape[0]):
                    parts.append(frag)  # whole fragment, reuse as-is
                else:
                    parts.append(frag[off:off + (j - i)])
                i = j
            if len(parts) == 1 and parts[0] is buf[rows[0]][0]:
                # single whole fragment: already pool-owned and
                # ledger-tracked (kind=cache) at offer time
                data = parts[0]
            else:
                # a lone part is a slice (a view) of its fragment: copy
                # it so the page owns exactly its own bytes
                data = parts[0].clone() if len(parts) == 1 \
                    else torch.cat(parts, dim=0)
                _ms.track_array(data, "cache",
                                device=plan.dev
                                if plan.device is not None else None)
        except Exception as e:  # noqa: BLE001 — caching is best-effort
            if _ms.is_oom(e):
                _ms.note_oom(e, site="cache",
                             detail=f"page build on {plan.dev}")
            _log.warning("frame-cache page build failed on %s: %s",
                         plan.dev, e)
            return
        page = _Page(key, data, start, len(rows),
                     hw or plan.hw or (0, 0))
        evicted = 0
        with self._lock:
            if key in self._pages:
                return  # racing loader built it first
            self._pages[key] = page
            self._live[plan.dev] = self._live.get(plan.dev, 0) \
                + page.nbytes
            self._inserts[plan.dev] = self._inserts.get(plan.dev, 0) + 1
            # pin into the building task's lease: a gather may follow,
            # and eviction mid-flight would free nothing
            self._pin_locked(page, plan.lease)
            evicted = self._evict_down_locked(plan.dev)
        _M_INSERTS.labels(device=plan.dev).inc()
        if evicted:
            _M_EVICTIONS.labels(device=plan.dev).inc(evicted)
            _tracing.add_event("cache.evict", device=plan.dev,
                               pages=evicted)

    def assemble(self, plan: Plan, fresh_rows: np.ndarray,
                 fresh_data: np.ndarray,
                 hw: Optional[Tuple[int, int]] = None) -> Any:
        """Build the device array for ``plan.rows``: a page-table
        gather over pinned pages plus ONE staging copy per contiguous
        run of fresh (decoded) rows — and every staged run is offered
        toward page completion on the way through, so the pool fills
        as a side effect of exactly the h2d the task pays anyway."""
        return self._assemble(plan, plan.rows, fresh_rows, fresh_data,
                              hw)

    def assemble_rows(self, plan: Plan, rows: np.ndarray,
                      fresh_rows: np.ndarray, fresh_data: np.ndarray,
                      hw: Optional[Tuple[int, int]] = None) -> Any:
        """Chunk-granular assemble (work-packet streaming): gather an
        arbitrary sorted subset of the plan's rows."""
        return self._assemble(plan, np.asarray(rows, np.int64),
                              fresh_rows, fresh_data, hw)

    def _assemble(self, plan: Plan, rows: np.ndarray,
                  fresh_rows: np.ndarray, fresh_data: np.ndarray,
                  hw: Optional[Tuple[int, int]] = None) -> Any:
        fresh_rows = np.asarray(fresh_rows, np.int64)
        pf = plan.page_frames
        # classify each requested row: resident page (hit at plan time
        # or inserted by offer() just now — re-check under the lock,
        # pinning any newly used page) or fresh decode
        with self._lock:
            pages: Dict[int, _Page] = {}
            lease_pages = set(id(p) for p in plan.lease._pages)
            src: List[Optional[_Page]] = []
            for r in rows.tolist():
                pidx = r // pf
                page = pages.get(pidx)
                if page is None:
                    key = (plan.dev,) + plan.skey + (pidx,)
                    page = self._pages.get(key)
                    if page is not None:
                        if not 0 <= r - page.start < page.n:
                            page = None
                    if page is not None:
                        pages[pidx] = page
                        self._pages.move_to_end(key)
                        if id(page) not in lease_pages:
                            self._pin_locked(page, plan.lease)
                            lease_pages.add(id(page))
                src.append(page)
        # segments: maximal runs of rows served by the same source
        segs: List[Tuple[Optional[_Page], int, int]] = []
        for i, page in enumerate(src):
            if segs and segs[-1][0] is page:
                segs[-1] = (page, segs[-1][1], i + 1)
            else:
                segs.append((page, i, i + 1))
        # zero-copy fast path: the request is exactly one whole page
        if len(segs) == 1 and segs[0][0] is not None:
            page, lo, hi = segs[0]
            if hi - lo == page.n and int(rows[0]) == page.start \
                    and int(rows[-1]) == page.start + page.n - 1:
                return page.data
        parts = []
        for page, lo, hi in segs:
            seg_rows = rows[lo:hi]
            if page is not None:
                local = seg_rows - page.start
                if len(local) > 1 and bool((np.diff(local) == 1).all()):
                    parts.append(page.data[int(local[0]):
                                           int(local[-1]) + 1])
                else:
                    parts.append(page.data[torch.as_tensor(
                        local, device=page.data.device)])
            else:
                pos = np.searchsorted(fresh_rows, seg_rows)
                if (pos >= len(fresh_rows)).any() or \
                        (fresh_rows[pos] != seg_rows).any():
                    raise CacheBypass(
                        "assemble: rows neither resident nor freshly "
                        "decoded")
                if len(pos) > 1 and bool((np.diff(pos) == 1).all()):
                    host = fresh_data[int(pos[0]):int(pos[-1]) + 1]
                else:
                    host = fresh_data[pos]
                staged = _stage(np.ascontiguousarray(host),
                                _target(plan), plan.dev, kind="staging")
                parts.append(staged)
                # page fill rides this same staged block on device —
                # never a second h2d for rows the task already shipped
                self._offer_block(plan, seg_rows, staged, hw)
        if not parts:
            return torch.from_numpy(
                np.ascontiguousarray(fresh_data[:0])).to(_target(plan))
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts, dim=0)

    # -- pinning / eviction ---------------------------------------------

    def _pin_locked(self, page: _Page, lease: Lease) -> None:
        if lease._released:
            # the task already ended (revoked/failed mid-stream): a pin
            # added now could never be released — leave the page
            # unpinned; the dead task's gather is refcount-safe anyway
            return
        page.pins += 1
        lease._pages.append(page)
        if page.pins == 1:
            dev = page.key[0]
            self._pinned[dev] = self._pinned.get(dev, 0) + page.nbytes

    def _release_lease(self, lease: Lease) -> None:
        with self._lock:
            if lease._released:
                return
            lease._released = True
            for page in lease._pages:
                page.pins -= 1
                if page.pins == 0:
                    dev = page.key[0]
                    self._pinned[dev] = max(
                        self._pinned.get(dev, 0) - page.nbytes, 0)
            lease._pages = []

    def _evict_down_locked(self, dev: str,
                           target: Optional[int] = None) -> int:
        """Pages AND fill fragments bill against the target (fragments
        are HBM like any page); incomplete fill buffers are the
        cheapest victims and go first, oldest first."""
        target = self._capacity(dev) if target is None else target
        evicted = 0
        while self._live.get(dev, 0) + self._fill_dev.get(dev, 0) \
                > target:
            fill_victim = next((k for k in self._fill if k[0] == dev),
                               None)
            if fill_victim is not None:
                self._drop_fill_locked(fill_victim)
                continue
            victim = None
            for key, page in self._pages.items():
                if key[0] == dev and page.pins == 0:
                    victim = key
                    break
            if victim is None:
                break  # everything pinned: transient overshoot
            page = self._pages.pop(victim)
            self._live[dev] = max(self._live.get(dev, 0) - page.nbytes,
                                  0)
            self._evictions[dev] = self._evictions.get(dev, 0) + 1
            evicted += 1
        return evicted

    # -- pressure actuation (ROADMAP item 5 seed) ------------------------

    def pressure_shrink(self, dev: str) -> int:
        """A firing hbm_pressure alert on `dev` sets the capacity
        target to HALF the cache's current occupancy (bounded by the
        old target, never below MIN_CAPACITY_BYTES) and evicts down
        NOW.  Deliberately occupancy-based, not target-based: with the
        pool under-full, halving a slack 256 MB target would evict
        nothing — pressure means the device needs bytes back
        immediately.  The shrunk target persists for the process (a
        device that hit pressure once is overcommitted; operators
        resize via [perf] frame_cache_mb)."""
        with self._lock:
            # single-chip / affinity-off pools key pages under
            # "default" (TaskItem.device is None there) while the
            # hbm_pressure alert names the real chip label: redirect so
            # the actuation reaches the pages that actually exist
            if dev not in self._live and dev not in self._fill_dev \
                    and ("default" in self._live
                         or "default" in self._fill_dev):
                _log.info("pressure shrink for %s redirected to the "
                          "default-placement pool", dev)
                dev = "default"
            occupied = self._live.get(dev, 0) + self._fill_dev.get(dev,
                                                                   0)
            cur = min(self._capacity(dev), max(occupied,
                                               MIN_CAPACITY_BYTES))
            new = max(MIN_CAPACITY_BYTES, cur // 2)
            self._target[dev] = new
            self._shrinks[dev] = self._shrinks.get(dev, 0) + 1
            evicted = self._evict_down_locked(dev, new)
        self._ensure_gauges(dev)
        _M_SHRINKS.labels(device=dev).inc()
        if evicted:
            _M_EVICTIONS.labels(device=dev).inc(evicted)
            _tracing.add_event("cache.evict", device=dev, pages=evicted,
                               reason="hbm_pressure")
        _log.warning(
            "hbm_pressure on %s: frame-cache target shrunk to %d MB "
            "(%d page(s) evicted)", dev, new >> 20, evicted)
        return evicted

    # -- introspection ---------------------------------------------------

    def status_dict(self) -> Dict[str, Any]:
        """The /statusz Frame-cache panel (per device)."""
        with self._lock:
            devs = sorted(set(self._live) | set(self._hits)
                          | set(self._misses) | set(self._fill_dev))
            pages: Dict[str, int] = {}
            for key in self._pages:
                pages[key[0]] = pages.get(key[0], 0) + 1
            out = {}
            for d in devs:
                h = self._hits.get(d, 0)
                m = self._misses.get(d, 0)
                out[d] = {
                    "pages": pages.get(d, 0),
                    "live_bytes": self._live.get(d, 0),
                    "fill_bytes": self._fill_dev.get(d, 0),
                    "pinned_bytes": self._pinned.get(d, 0),
                    "capacity_bytes": self._capacity(d),
                    "hits": h, "misses": m,
                    "hit_rate": round(h / (h + m), 4) if h + m else None,
                    "evictions": self._evictions.get(d, 0),
                    "pressure_shrinks": self._shrinks.get(d, 0),
                }
        return {"enabled": _ENABLED, "devices": out,
                "page_frames": {"/".join(map(str, k)): v
                                for k, v in self._page_frames.items()}}

    def clear(self) -> None:
        """Drop every unpinned page and all fill buffers (tests, bench
        A/B resets; table-rewrite hygiene is keyed by table id, which
        create_table mints fresh).  PINNED pages survive — an in-flight
        streaming task's plan-time hits must stay resident (its
        assemble has no fallback for rows that vanish mid-task), same
        rule eviction follows."""
        with self._lock:
            for key in [k for k, p in self._pages.items()
                        if p.pins == 0]:
                del self._pages[key]
            self._fill.clear()
            self._fill_nbytes.clear()
            self._fill_dev = {d: 0 for d in self._fill_dev}
            self._page_frames.clear()
            live: Dict[str, int] = {d: 0 for d in self._live}
            for key, p in self._pages.items():
                live[key[0]] = live.get(key[0], 0) + p.nbytes
            self._live = live
            self._target.clear()


def _nbytes(t: Any) -> int:
    return int(t.numel() * t.element_size()) \
        if isinstance(t, torch.Tensor) else 0


def _target(plan: Plan) -> torch.device:
    """Where a plan's fresh rows stage: its device, or the host for a
    plan made without one (the pool is then the "default" one)."""
    return plan.device if plan.device is not None else torch.device("cpu")


def _stage(host: np.ndarray, device: Any, dev: str, kind: str) -> Any:
    """The cache's fresh-row staging: the shared batch.staged_device_put
    contract (fault site, OOM forensics at site=staging, h2d meters,
    ledger) with a detail that LEADS with the ledger kind, so chaos
    plans can target argument staging (match=staging, propagates) apart
    from the absorbed page-build site (match=cache — _build_page arms
    its own injection)."""
    from .batch import staged_device_put
    return staged_device_put(
        host, device, kind,
        fault_detail=f"{kind} h2d {dev} {host.nbytes}b")


# ---------------------------------------------------------------------------
# process-wide singleton + hbm_pressure wiring
# ---------------------------------------------------------------------------

_CACHE: Optional[FrameCache] = None
_CACHE_LOCK = threading.Lock()


def _on_alert(transition: Dict[str, Any]) -> Optional[str]:
    """The shrink actuation: hbm_pressure firing -> shrink + evict.
    Registered with the remediation controller as the
    ``shrink_frame_cache`` action behind the ``frame_cache_shrink``
    playbook (engine/controller.py: cooldown, dry-run, audit and the
    SCANNER_TPU_REMEDIATION kill switch apply).  Still callable
    directly with a transition dict — the rule/state filter stays so
    private health engines can use it as a bare listener in tests.
    Returns what it did, for the controller's audit entry."""
    if transition.get("rule") != "hbm_pressure" \
            or transition.get("state") != "firing":
        return None
    dev = (transition.get("labels") or {}).get("device")
    if dev and _CACHE is not None:
        try:
            evicted = _CACHE.pressure_shrink(dev)
            return f"{dev}: {evicted} page(s) evicted"
        except Exception:  # noqa: BLE001 — actuation must never kill
            _log.exception("pressure shrink failed for %s", dev)
    return None


def cache() -> FrameCache:
    """The process-wide pool (created on first use; binds the
    hbm_pressure shrink to the remediation controller's
    frame_cache_shrink playbook).  With SCANNER_TPU_REMEDIATION=0 the
    controller never attaches to the health engine, so the cache is
    signal-only: the alert fires, nothing shrinks."""
    global _CACHE
    with _CACHE_LOCK:
        if _CACHE is None:
            _CACHE = FrameCache()
            from . import controller as _controller
            _controller.register_action("shrink_frame_cache", _on_alert)
            _controller.ensure_started()
        return _CACHE


def status_dict() -> Dict[str, Any]:
    """Quiet form for /statusz when no cache exists yet (a scrape must
    not allocate one as a side effect)."""
    if _CACHE is None:
        return {"enabled": _ENABLED, "devices": {}, "page_frames": {}}
    return _CACHE.status_dict()


def attach_lease(task_item: Any, lease: Lease) -> None:
    """Hang a lease off its TaskItem: the executor releases it when
    evaluation finishes; the finalizer is the backstop for tasks an
    aborted pipeline never evaluates (pins must not outlive the task).
    The finalizer is installed FIRST and the list handled through a
    local — a concurrent _release_cache swap-to-None (revoked streaming
    task) must neither crash this thread nor orphan the lease."""
    weakref.finalize(task_item, lease.release)
    leases = getattr(task_item, "cache_leases", None)
    if leases is None:
        leases = []
        task_item.cache_leases = leases
    leases.append(lease)
