"""Batched column data for task evaluation.

The reference keeps per-element buffers from a pooled block allocator and
re-packs them into batches at each kernel call
(scanner/util/memory.cpp:269 BlockAllocator,
scanner/engine/evaluate_worker.cpp:1040-1100 batching).  On an accelerator the natural
design is stronger: a task's column is ONE contiguous array the whole way —
decoded straight into a batch buffer, moved host->device once, sliced (not
copied) into kernel calls, chained op-to-op as device arrays, and fetched
back exactly once at the sink.

`ColumnBatch` is that representation.  `data` is one of
  - ``np.ndarray``  — host batch, axis 0 = rows (uniform frames/blobs)
  - ``torch.Tensor`` — device batch, axis 0 = rows
  - ``list``        — arbitrary python objects (ragged frames, tuples, ...)
plus a sorted ``rows`` vector naming the (stream-local or global) row ids
and an optional ``nulls`` mask.  Gathers/slices on array data are views or
device ops; nothing round-trips through per-row python objects unless a
per-row (batch=1, non-array) consumer asks for it.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Sequence

import numpy as np

import torch

from ..common import NullElement
from ..util import faults as _faults
from ..util import memstats as _ms
from ..util import metrics as _mx

Elem = Any

# host<->device traffic over the PCIe link as a live pair of counters
# (rate = delta bytes / delta seconds).  h2d seconds cover the staging
# call (the pinned copy plus the dispatch of the async transfer, whose
# completion rides under later compute by design), d2h seconds are the
# full blocking fetch.
_M_H2D_BYTES = _mx.registry().counter(
    "scanner_tpu_h2d_bytes_total",
    "Bytes staged host->device via ColumnBatch.to_device.")
_M_H2D_SECONDS = _mx.registry().counter(
    "scanner_tpu_h2d_seconds_total",
    "Seconds spent in host->device staging calls (dispatch side).")
_M_D2H_BYTES = _mx.registry().counter(
    "scanner_tpu_d2h_bytes_total",
    "Bytes fetched device->host via ColumnBatch.to_host.")
_M_D2H_SECONDS = _mx.registry().counter(
    "scanner_tpu_d2h_seconds_total",
    "Seconds spent blocking on device->host fetches.")


def pinned_empty(shape: tuple, dtype) -> "np.ndarray":
    """An uninitialised host array in PyTorch's pinned (page-locked)
    memory, the whole of a pinned tensor, which `staged_device_put`
    ships to a CUDA device with no copy of its own; a plain `np.empty`
    for a dtype a tensor cannot hold."""
    try:
        torch_dtype = torch.from_numpy(np.empty(0, dtype)).dtype
    except (TypeError, ValueError):
        return np.empty(shape, dtype)
    try:
        return torch.empty(shape, dtype=torch_dtype, pin_memory=True).numpy()
    except Exception as e:
        if _ms.is_oom(e):
            _ms.note_oom(e, site="staging", detail=f"pinned {shape} {dtype}")
        raise


def _pinned_whole(host: "np.ndarray") -> Optional[torch.Tensor]:
    """The pinned tensor `host` is the whole of (`pinned_empty`), or
    None."""
    t = host.base
    if (isinstance(t, torch.Tensor) and t.is_pinned()
            and tuple(t.shape) == host.shape
            and t.data_ptr() == host.ctypes.data):
        return t
    return None


def staged_device_put(host: "np.ndarray", device, kind: str,
                      fault_detail: str) -> torch.Tensor:
    """The ONE engine host->device staging contract: the memory.pressure
    fault site, out-of-memory forensics (site=staging), the shared h2d
    byte/second meters and an allocation-ledger registration under
    `kind`, around one copy of `host` into pinned memory and an
    asynchronous (non_blocking) copy of that onto `device`.  A `host`
    already in pinned memory (`pinned_empty`) skips the first copy; its
    owner writes it no more.  PyTorch's pinned-memory allocator hands the
    pinned buffer out again only once the copy on the current stream is
    done."""
    t0 = time.time()
    try:
        if _faults.ACTIVE:
            _faults.inject("memory.pressure", detail=fault_detail)
        src = _pinned_whole(host) if device.type == "cuda" else None
        if src is None:
            src = torch.from_numpy(np.ascontiguousarray(host))
            if device.type == "cuda":
                src = src.pin_memory()
        data = src.to(device, non_blocking=True)
    except Exception as e:
        if _ms.is_oom(e):
            _ms.note_oom(e, site="staging",
                         detail=f"h2d {host.nbytes} bytes -> {device}")
        raise
    _M_H2D_SECONDS.inc(time.time() - t0)
    _M_H2D_BYTES.inc(host.nbytes)
    _ms.track_array(data, kind)
    return data


def _is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def is_array_data(data) -> bool:
    return isinstance(data, (np.ndarray, torch.Tensor))


def _index(data, idx):
    """Gather rows `idx` (a numpy int array) of array data: numpy
    fancy indexing, or a gather on the tensor's device."""
    if _is_tensor(data):
        return data[torch.as_tensor(np.asarray(idx, np.int64),
                                    device=data.device)]
    return data[idx]


def to_numpy(data) -> np.ndarray:
    """A tensor's values as a numpy array (a host copy for device
    tensors); numpy arrays pass through."""
    if _is_tensor(data):
        return data.detach().cpu().numpy()
    return np.asarray(data)


class ColumnBatch:
    """One column of one task: row ids + batched data (+ null mask).

    ``convert`` marks data stored in a pre-conversion wire format:
    ``("yuv420", h, w)`` means rows are flat planar I420 frames staged at
    1.5 B/px; ``converted()`` turns them into (n, h, w, 3) RGB where the
    data lives (on the tensor's device, numpy for host).  Row-axis
    transforms (take/relabel/concat) preserve the mark — builtin gathers
    never look inside a frame — and any per-row host materialization
    converts transparently so no consumer can observe raw YUV bytes.
    """

    __slots__ = ("rows", "data", "nulls", "convert", "_row_pos",
                 "_pending")

    def __init__(self, rows: np.ndarray, data,
                 nulls: Optional[np.ndarray] = None,
                 convert: Optional[tuple] = None):
        self.rows = np.asarray(rows, np.int64)
        self.data = data
        self.nulls = nulls if nulls is None or nulls.any() else None
        self.convert = convert
        self._row_pos = None
        # (pinned host tensor, cuda event) of a d2h copy prefetch_host
        # started; to_host waits on the event
        self._pending = None
        if not is_array_data(data) and len(data) != len(self.rows):
            raise ValueError(
                f"ColumnBatch: {len(data)} elements for {len(self.rows)} rows")
        if len(self.rows) > 1 and (np.diff(self.rows) <= 0).any():
            raise ValueError("ColumnBatch rows must be strictly increasing")

    # -- construction ---------------------------------------------------

    @staticmethod
    def from_elements(rows: Sequence[int], elems: Sequence[Elem]
                      ) -> "ColumnBatch":
        """Build from per-row elements; packs uniform ndarrays into one
        host batch, otherwise stores the object list."""
        rows = np.asarray(list(rows), np.int64)
        elems = list(elems)
        nulls = np.array([isinstance(e, NullElement) or e is None
                          for e in elems], bool)
        if nulls.all():
            return ColumnBatch(rows, [NullElement()] * len(elems), nulls)
        live = [e for e, n in zip(elems, nulls) if not n]
        first = live[0]
        if (isinstance(first, np.ndarray)
                and all(isinstance(e, np.ndarray) and e.shape == first.shape
                        and e.dtype == first.dtype for e in live)):
            if not nulls.any() and len(live) == len(elems):
                return ColumnBatch(rows, np.stack(elems))
            batch = np.zeros((len(elems),) + first.shape, first.dtype)
            batch[~nulls] = np.stack(live)
            return ColumnBatch(rows, batch, nulls)
        return ColumnBatch(rows, elems, nulls if nulls.any() else None)

    # -- row lookup -----------------------------------------------------

    def positions(self, rows: np.ndarray) -> np.ndarray:
        """Positions of `rows` (must all be present) in this batch."""
        pos = np.searchsorted(self.rows, rows)
        if (pos >= len(self.rows)).any() or (self.rows[pos] != rows).any():
            missing = sorted(set(np.asarray(rows).tolist())
                             - set(self.rows.tolist()))
            raise KeyError(f"rows not in batch: {missing[:5]}...")
        return pos

    # -- transforms (device-aware; views/slices where possible) ---------

    def take(self, positions: np.ndarray,
             new_rows: np.ndarray) -> "ColumnBatch":
        """Gather positions (−1 ⇒ null row) and relabel to new_rows."""
        positions = np.asarray(positions, np.int64)
        new_rows = np.asarray(new_rows, np.int64)
        neg = positions < 0
        nulls = None
        if self.nulls is not None:
            nulls = np.where(neg, True, self.nulls[np.where(neg, 0,
                                                            positions)])
        elif neg.any():
            nulls = neg
        safe = np.where(neg, 0, positions)
        if isinstance(self.data, np.ndarray):
            # contiguous slice stays a view
            if (not neg.any() and len(safe)
                    and np.array_equal(safe,
                                       np.arange(safe[0],
                                                 safe[0] + len(safe)))):
                data = self.data[safe[0]:safe[0] + len(safe)]
            else:
                data = self.data[safe]
        elif _is_tensor(self.data):
            data = _index(self.data, safe)  # on-device gather
        else:
            data = [NullElement() if neg[i] else self.data[int(p)]
                    for i, p in enumerate(safe)]
        return ColumnBatch(new_rows, data, nulls, convert=self.convert)

    def _contig_slice(self, start_row: int, k: int,
                      new_rows: np.ndarray) -> Optional["ColumnBatch"]:
        """Slice rows [start_row, start_row+k) directly if they are all
        present and contiguous in this batch (two binary-searched
        endpoint checks instead of a full positions lookup; array data
        stays a view).  None = not contiguous here, use the slow path."""
        p0 = int(np.searchsorted(self.rows, start_row))
        if p0 + k > len(self.rows) or self.rows[p0] != start_row \
                or self.rows[p0 + k - 1] != start_row + k - 1:
            return None
        nulls = self.nulls[p0:p0 + k] if self.nulls is not None else None
        return ColumnBatch(new_rows, self.data[p0:p0 + k], nulls,
                           convert=self.convert)

    def take_rows(self, rows: np.ndarray,
                  new_rows: Optional[np.ndarray] = None) -> "ColumnBatch":
        rows = np.asarray(rows, np.int64)
        nr = rows if new_rows is None else new_rows
        # contiguous [start, end) fast path — the sink hot path fetches
        # exactly this shape once per task
        k = len(rows)
        if k and len(self.rows) and int(rows[-1]) - int(rows[0]) == k - 1 \
                and (k == 1 or bool((np.diff(rows) == 1).all())):
            out = self._contig_slice(int(rows[0]), k, nr)
            if out is not None:
                return out
        return self.take(self.positions(rows), nr)

    def take_range(self, start: int, end: int) -> "ColumnBatch":
        """take_rows for the contiguous row range [start, end) without
        the caller materializing an index or this batch running the full
        positions lookup (executor._sink_rows hot path)."""
        rows = np.arange(start, end, dtype=np.int64)
        if len(rows) and len(self.rows):
            out = self._contig_slice(int(start), len(rows), rows)
            if out is not None:
                return out
        return self.take(self.positions(rows), rows)

    def relabel(self, new_rows: np.ndarray) -> "ColumnBatch":
        """Same data, new row ids (slice/unslice row renumbering)."""
        return ColumnBatch(new_rows, self.data, self.nulls,
                           convert=self.convert)

    # -- device movement ------------------------------------------------

    def to_device(self, device: torch.device) -> "ColumnBatch":
        """Host -> device, one async transfer for the whole batch.  A
        batch already on a tensor is moved only when it sits on another
        device than the requested one.  A convert-marked batch ships its
        WIRE format (that is the point: 1.5 B/px over the link, convert
        on device via converted())."""
        if isinstance(self.data, np.ndarray):
            data = staged_device_put(
                self.data, device, "staging",
                fault_detail=f"h2d:{device}:{self.data.nbytes}")
            return ColumnBatch(self.rows, data,
                               self.nulls, convert=self.convert)
        if _is_tensor(self.data) and self.data.device != device:
            try:
                data = self.data.to(device, non_blocking=True)
            except Exception as e:
                if _ms.is_oom(e):
                    _ms.note_oom(e, site="staging",
                                 detail=f"cross-device re-stage -> "
                                        f"{device}")
                raise
            _ms.track_array(data, "staging")
            return ColumnBatch(self.rows, data,
                               self.nulls, convert=self.convert)
        return self

    def prefetch_host(self) -> "ColumnBatch":
        """Start this batch's device->host copy WITHOUT blocking (the
        async half of the sink fetch): called at eval-done so the d2h
        copy of task k rides under the evaluation of task k+1 instead of
        serializing inside the saver.  The copy goes into pinned host
        memory on the current stream; the later to_host() waits on its
        event.  No-op for host data and CPU tensors."""
        if _is_tensor(self.data) and self.data.device.type == "cuda" \
                and self._pending is None:
            # the sink batch holds device memory until the saver's
            # fetch: account it so pre-fetch pressure has an owner
            _ms.track_array(self.data, "sink")
            host = torch.empty(self.data.shape, dtype=self.data.dtype,
                               pin_memory=True)
            host.copy_(self.data, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._pending = (host, ev)
        return self

    def to_host(self) -> "ColumnBatch":
        """Materialize device data on host (the single sink-side fetch)."""
        if _is_tensor(self.data):
            t0 = time.time()
            if self._pending is not None:
                host, ev = self._pending
                ev.synchronize()
                data = host.numpy()
            else:
                data = to_numpy(self.data)
            _M_D2H_SECONDS.inc(time.time() - t0)
            _M_D2H_BYTES.inc(data.nbytes)
            return ColumnBatch(self.rows, data, self.nulls,
                               convert=self.convert)
        return self

    def converted(self) -> "ColumnBatch":
        """Resolve a pending wire-format conversion (no-op otherwise).
        Tensors convert on their own device, host arrays with the
        bit-identical numpy flavor (kernels/color.py)."""
        if self.convert is None:
            return self
        kind, h, w = self.convert
        if kind != "yuv420":
            raise ValueError(f"unknown convert mark {self.convert!r}")
        from ..kernels.color import yuv420_to_rgb_device, yuv420_to_rgb_host
        if _is_tensor(self.data):
            data = yuv420_to_rgb_device(self.data, h, w)
        elif isinstance(self.data, np.ndarray):
            data = yuv420_to_rgb_host(self.data, h, w)
        else:
            raise ValueError(
                "convert-marked batch holds non-array data")
        return ColumnBatch(self.rows, data, self.nulls)

    # -- per-row access (host materialization boundary) -----------------

    def __len__(self) -> int:
        return len(self.rows)

    def is_null_pos(self, pos: int) -> bool:
        return self.nulls is not None and bool(self.nulls[pos])

    def element_at(self, pos: int) -> Elem:
        """Element at position `pos` (a view for host arrays; a
        convert-marked batch yields the CONVERTED row — raw wire bytes
        are never observable per-row)."""
        if self.is_null_pos(pos):
            return NullElement()
        if self.convert is not None:
            from ..kernels.color import yuv420_to_rgb_host
            _kind, h, w = self.convert
            row = to_numpy(self.data[pos])
            return yuv420_to_rgb_host(row, h, w)
        if _is_tensor(self.data):
            return to_numpy(self.data[pos])
        return self.data[pos]

    def elements(self) -> List[Elem]:
        """All elements as per-row host objects (sink/write boundary)."""
        host = self.to_host()
        return [host.element_at(i) for i in range(len(host))]

    def get_row(self, row: int) -> Elem:
        return self.element_at(int(self.positions(
            np.asarray([row], np.int64))[0]))


def concat_batches(parts: List[ColumnBatch]) -> ColumnBatch:
    """Concatenate row-disjoint batches (already in row order)."""
    if len(parts) == 1:
        return parts[0]
    converts = {p.convert for p in parts}
    if len(converts) > 1:
        # mixed wire formats (shouldn't happen within one column; be safe)
        parts = [p.converted() for p in parts]
        converts = {None}
    convert = next(iter(converts))
    rows = np.concatenate([p.rows for p in parts])
    nulls = None
    if any(p.nulls is not None for p in parts):
        nulls = np.concatenate(
            [p.nulls if p.nulls is not None else np.zeros(len(p), bool)
             for p in parts])
    datas = [p.data for p in parts]
    if all(isinstance(d, np.ndarray) for d in datas) and \
            len({(d.shape[1:], d.dtype) for d in datas}) == 1:
        return ColumnBatch(rows, np.concatenate(datas), nulls,
                           convert=convert)
    if all(_is_tensor(d) for d in datas) and \
            len({(tuple(d.shape[1:]), d.dtype, d.device)
                 for d in datas}) == 1:
        return ColumnBatch(rows, torch.cat(datas), nulls, convert=convert)
    # mixed / ragged: fall back to object list
    elems: List[Elem] = []
    for p in parts:
        elems.extend(p.elements())
    return ColumnBatch(rows, elems, nulls)
