"""Per-task graph evaluation over batched columns.

Capability parity: reference scanner/engine/evaluate_worker.cpp:408-1328
(EvaluateWorker: row bookkeeping, stencil cache, batching, builtin
sample/space/slice/unslice remapping, per-slice arg rebinding, state reset).

One TaskEvaluator owns the kernel instances of one pipeline instance and
executes tasks end-to-end in column space: {(node_id, column): ColumnBatch}.
A task's frames live in ONE contiguous batch from decode to sink — builtins
are vectorized gathers/relabels on the batch, device kernels receive
on-device slices and chain device-to-device, with a single host->device
transfer per column.

Device placement is explicit: the evaluator is given the torch.device its
client runs on.  On a CUDA device every device kernel's input columns are
staged onto the card (instance i of an executor owns card i mod n) and
device kernels launch their CUDA kernels there; on the CPU the columns
stay numpy and device kernels run their host flavors.  There is no probe
and no fallback: asking for "cuda" without a card raises.

Bucketed dispatch: device-kernel calls are rounded up a small power-of-two
bucket ladder (`bucket_ladder`).  A tail chunk pads up to the next bucket
by edge-repeating its last row (the REPEAT_EDGE convention stencils
already use) and the padding is sliced off before results are emitted;
null-propagated rows ride through the call at the full chunk shape and
are overwritten with NullElement afterward.  The JAX package does this so
that XLA compiles a bounded executable set; the port keeps the same
calling convention so both packages make the same kernel calls.
Host/python kernels keep exact shapes, and stateful kernels do too
(padding rows would advance their state)."""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import (DeviceType, JobException, NullElement,
                      ScannerException, SliceList)
from ..graph import analysis as A
from ..graph import ops as O
from ..util import metrics as _mx
from ..util import tracing as _tracing
from ..util.log import get_logger
from ..util.profiler import Profiler
from .batch import ColumnBatch, _index, concat_batches, is_array_data

_log = get_logger("evaluate")

# per-op live throughput: fps = delta rows / delta seconds per op label
_M_OP_ROWS = _mx.registry().counter(
    "scanner_tpu_op_rows_total",
    "Rows evaluated per op (kernel calls, warmup rows included).",
    labels=["op"])
_M_OP_SECONDS = _mx.registry().counter(
    "scanner_tpu_op_seconds_total",
    "Wall seconds spent inside each op's kernel calls.",
    labels=["op"])
_M_OP_SHAPES = _mx.registry().counter(
    "scanner_tpu_op_recompiles_total",
    "New input (device, shape, dtype) signatures seen per op; with "
    "bucketed dispatch this is bounded by the op's bucket-ladder size "
    "per device.",
    labels=["op", "device"])
_M_OP_PAD_ROWS = _mx.registry().counter(
    "scanner_tpu_op_pad_rows_total",
    "Edge-repeat padding rows added by bucketed dispatch to round tail "
    "chunks up to a bucket shape, per op and assigned device.",
    labels=["op", "device"])

Elem = Any  # np.ndarray | bytes | arbitrary python object | NullElement
ColKey = Tuple[int, str]  # (node id, column name)


def _is_null(e: Elem) -> bool:
    return isinstance(e, NullElement)


# ---------------------------------------------------------------------------
# Device placement
# ---------------------------------------------------------------------------


def resolve_device(device: Any = "cuda") -> torch.device:
    """The torch.device a client runs on: "cuda" (the default; the
    current card), "cuda:N", "cpu", or a torch.device.  Asking for CUDA
    without a card raises — the port never carries on silently on the
    CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise ScannerException(
                f"device {device!r} requested but no CUDA card is "
                f"available (pass device='cpu' to run on the host)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.index >= torch.cuda.device_count():
            raise ScannerException(
                f"device {device!r}: only {torch.cuda.device_count()} "
                f"CUDA card(s) present")
    elif dev.type != "cpu":
        raise ScannerException(f"unsupported device {device!r}")
    return dev


def assigned_device(device: torch.device, instance: int) -> torch.device:
    """The device pipeline instance `instance` owns: card
    (device.index + instance) mod n on CUDA (with one card, every
    instance owns cuda:0), the CPU otherwise.  Used by both the
    evaluator and the executor (TaskItem device assignment at enqueue
    time): one mapping, two sides of the handoff."""
    if device.type != "cuda":
        return device
    n = torch.cuda.device_count()
    return torch.device("cuda", (device.index + instance) % n)


def default_pipeline_instances(configured: Optional[int],
                               device: torch.device) -> int:
    """An explicit count wins — any explicit value, including 1; an
    unset one (None/0) is one instance per card on a multi-card host,
    else 1."""
    if configured:
        return int(configured)
    if device.type == "cuda" and torch.cuda.device_count() > 1:
        return torch.cuda.device_count()
    return 1


def device_label(device: Optional[torch.device]) -> str:
    return "default" if device is None else str(device)


# ---------------------------------------------------------------------------
# Bucketed dispatch
# ---------------------------------------------------------------------------

# smallest bucket: a ladder of {4, 8, ..., cap} bounds the executable
# count at log2(cap/4)+1 while wasting at most 3 padded rows on the
# tiniest call
_MIN_BUCKET = 4


def bucket_ladder(cap: int) -> List[int]:
    """Batch-size buckets for a kernel whose per-call batch cap is `cap`:
    powers of two from min(4, cap) up, with `cap` itself as the top rung
    (so a full chunk never pads).  Every bucketed device-kernel call has
    one of these batch sizes."""
    cap = max(1, int(cap))
    if cap <= _MIN_BUCKET:
        return [cap]
    ladder = []
    b = _MIN_BUCKET
    while b < cap:
        ladder.append(b)
        b <<= 1
    ladder.append(cap)
    return ladder


def bucket_for(k: int, ladder: Sequence[int]) -> int:
    """Smallest ladder bucket >= k (k must be <= ladder[-1])."""
    for b in ladder:
        if b >= k:
            return b
    return ladder[-1]


def _strip_pad(res, k: int, n_out: int):
    """Drop bucket-padding rows from a kernel result before emission.
    Accepts every result protocol emit_result does: a single batch, a
    tuple of per-column batches, or a list of per-row results/tuples."""
    if n_out > 1 and isinstance(res, tuple) and len(res) == n_out:
        return tuple(r[:k] for r in res)
    try:
        return res[:k]
    except TypeError:
        return res  # malformed result: let emit_result raise its error


class StateCarryMiss(Exception):
    """A carry plan's premise failed: the kernel instance's state is not
    positioned at the plan's watermark (task reordering, a failed
    predecessor, or a different instance).  The executor catches this and
    re-runs the task with a self-contained plan — affinity is a pure
    optimization, never a correctness dependency."""


class KernelInstance:
    """One live kernel with its stream/state bookkeeping."""

    def __init__(self, node: O.OpNode, profiler: Profiler,
                 devices: Optional[List[Any]] = None,
                 device: Optional[Any] = None):
        assert node.spec is not None and node.spec.kernel_factory is not None
        self.node = node
        self.spec = node.spec
        cfg = O.KernelConfig(device=node.effective_device(),
                             args=dict(node.init_args),
                             devices=devices or [])
        # canonical class identity: an unpickled job spec can carry a
        # cloudpickle by-value class COPY of a locally-registered op;
        # instantiating the registered original keeps class-level state
        # (and identity-sensitive tests) on one class object
        factory = O.registry.canonical_factory(self.spec)
        self.kernel = factory(cfg, **node.init_args)
        self.profiler = profiler
        # the device this instance's calls are pinned to; None for host
        # kernels
        self.device = device
        self.dev_label = device_label(device)
        self._cur_stream: Tuple[int, int] = (-1, -1)  # (job, slice group)
        self._last_row: Optional[int] = None
        self._did_setup = False
        # input (device, shape, dtype) signatures already executed
        self._shape_sigs: set = set()

    def setup(self, fetch: bool = True) -> None:
        if not self._did_setup:
            if fetch:
                self.kernel.fetch_resources()
            self.kernel.setup_with_resources()
            self._did_setup = True

    def stream_args(self, job_idx: int, slice_group: int) -> dict:
        """The per-stream kwargs new_stream would receive for this
        (job, slice group)."""
        args = {}
        for name, per_stream in self.node.job_args.items():
            if name not in self.spec.stream_arg_names:
                continue
            v = per_stream[job_idx]
            if isinstance(v, SliceList):
                v = v[slice_group]
            args[name] = v
        return args

    def bind_stream(self, job_idx: int, slice_group: int) -> None:
        """Call new_stream when the (job, slice group) changes
        (reference evaluate_worker.cpp:640-707 per-slice arg rebinding)."""
        key = (job_idx, slice_group)
        if key == self._cur_stream:
            return
        self.kernel.new_stream(**self.stream_args(job_idx, slice_group))
        self.kernel.reset()
        self._cur_stream = key
        self._last_row = None

    def maybe_reset(self, row: int) -> None:
        """Reset state at row discontinuities (the reference kernel checks
        element indices itself, test_ops.cpp:183-189; we centralize it)."""
        if self._last_row is not None and row != self._last_row + 1 \
                and self.spec.is_stateful:
            self.kernel.reset()
        self._last_row = row

    def close(self) -> None:
        self.kernel.close()


class TaskEvaluator:
    def __init__(self, info: A.GraphInfo, profiler: Profiler,
                 device: torch.device,
                 stage: Optional[bool] = None,
                 skip_fetch_resources: bool = False,
                 instance: int = 0):
        """`device` is the client's device.  `stage` says whether device
        kernels' input columns are staged onto this instance's device as
        tensors; it defaults to True exactly when that is a CUDA card."""
        self.info = info
        self.profiler = profiler
        self.instance = instance
        self.device = assigned_device(device, instance)
        self.stage = (self.device.type == "cuda") if stage is None \
            else bool(stage)
        self.kernels: Dict[int, KernelInstance] = {}
        for n in info.ops:
            if not n.is_builtin:
                on_dev = n.effective_device() == DeviceType.TPU
                self.kernels[n.id] = KernelInstance(
                    n, profiler, [self.device] if on_dev else None,
                    device=self.device if on_dev else None)
        for ki in self.kernels.values():
            ki.setup(fetch=not skip_fetch_resources)

    def close(self) -> None:
        for ki in self.kernels.values():
            ki.close()

    # ------------------------------------------------------------------

    def execute_task(self, jr: A.JobRows, plan: A.TaskPlan,
                     source_batches: Dict[int, ColumnBatch]
                     ) -> Dict[int, ColumnBatch]:
        """Run one task.  source_batches: Input node id -> ColumnBatch.
        Returns sink node id -> ColumnBatch of output rows."""
        store: Dict[ColKey, ColumnBatch] = {}
        results: Dict[int, ColumnBatch] = {}
        # remaining column-reads per producer: a column is dropped from the
        # store the moment its last consumer has run, so peak host/device
        # memory is the live frontier, not every intermediate of the task
        # (the reference streams work packets through stages instead,
        # worker.cpp stage loops; with batched columns, freeing eagerly
        # achieves the same bound per io-packet)
        remaining = {nid: len(lst)
                     for nid, lst in self.info.consumers.items()}
        self.last_peak_columns = 0

        for n in self.info.ops:
            ts = plan.streams[n.id]
            if n.name == O.INPUT_OP:
                store[(n.id, "output")] = source_batches[n.id]
            elif n.name in (O.SAMPLE_OP, O.SPACE_OP):
                store[(n.id, "output")] = self._run_sampler(n, jr, plan, store)
            elif n.name == O.SLICE_OP:
                store[(n.id, "output")] = self._run_slice(n, jr, plan, store)
            elif n.name == O.UNSLICE_OP:
                store[(n.id, "output")] = self._run_unslice(n, jr, plan, store)
            elif n.name == O.OUTPUT_OP:
                src = n.input_columns()[0]
                results[n.id] = store[(src.op.id, src.column)].take_rows(
                    ts.valid_output_rows)
            else:
                outs = self._run_kernel(n, jr, plan, store)
                for col, b in outs.items():
                    store[(n.id, col)] = b
            self.last_peak_columns = max(self.last_peak_columns, len(store))
            for c in n.input_columns():
                pid = c.op.id
                remaining[pid] -= 1
                if remaining[pid] == 0:
                    for key in [k for k in store if k[0] == pid]:
                        del store[key]
        return results

    # -- builtins (vectorized gathers on the batch) ---------------------

    def _input_batch(self, n: O.OpNode, store) -> ColumnBatch:
        src = n.input_columns()[0]
        return store[(src.op.id, src.column)]

    def _run_sampler(self, n, jr, plan, store) -> ColumnBatch:
        ts = plan.streams[n.id]
        g = plan.slice_group if self.info.slice_level[n.id] > 0 else 0
        sampler = jr.samplers[n.id][g]
        in_b = self._input_batch(n, store)
        up_rows = ts.valid_input_rows
        down_rows, mapping = sampler.downstream_map(up_rows)
        need = np.asarray(ts.valid_output_rows, np.int64)
        pos_in_down = {int(d): i for i, d in enumerate(down_rows.tolist())}
        try:
            sel = np.array([pos_in_down[int(d)] for d in need.tolist()],
                           np.int64)
        except KeyError:
            missing = sorted(set(need.tolist()) - pos_in_down.keys())
            raise JobException(
                f"{n.name}: missing output rows {missing[:5]}...")
        m_sel = np.asarray(mapping, np.int64)[sel] if len(sel) else sel
        if not len(up_rows) or (m_sel < 0).all():
            return ColumnBatch.from_elements(
                need, [NullElement()] * len(need))
        src_rows = up_rows[np.maximum(m_sel, 0)]
        positions = in_b.positions(np.asarray(src_rows, np.int64))
        positions = np.where(m_sel < 0, -1, positions)
        return in_b.take(positions, need)

    def _run_slice(self, n, jr, plan, store) -> ColumnBatch:
        ts = plan.streams[n.id]
        group = jr.partitioners[n.id].group_at(plan.slice_group)
        in_b = self._input_batch(n, store)
        need = np.asarray(ts.valid_output_rows, np.int64)
        src = np.asarray(group, np.int64)[need]
        return in_b.take(in_b.positions(src), need)

    def _run_unslice(self, n, jr, plan, store) -> ColumnBatch:
        ts = plan.streams[n.id]
        inp = n.input_columns()[0].op
        offset = int(np.concatenate(
            [[0], np.cumsum(jr.rows[inp.id])])[plan.slice_group])
        in_b = self._input_batch(n, store)
        need = np.asarray(ts.valid_output_rows, np.int64)
        return in_b.take(in_b.positions(need - offset), need)

    # -- regular kernels -----------------------------------------------

    def _run_kernel(self, n: O.OpNode, jr: A.JobRows, plan: A.TaskPlan,
                    store) -> Dict[str, ColumnBatch]:
        ts = plan.streams[n.id]
        ki = self.kernels[n.id]
        ki.bind_stream(plan.job_idx, plan.slice_group)

        in_cols = n.input_columns()
        in_batches = [store[(c.op.id, c.column)] for c in in_cols]
        g = plan.slice_group if self.info.slice_level[n.id] > 0 else 0
        in_op = in_cols[0].op
        max_in = jr.rows[in_op.id][g]
        stencil = n.effective_stencil()
        has_stencil = stencil != [0]
        # The batch DECLARATION fixes the calling convention (batched
        # kernels always receive row batches, even 1-row ones) and CAPS
        # the per-call batch (ops declare it as a memory bound); within
        # that cap, PerfParams.work_packet_size sets the chunk — the
        # kernel's batch dimension (reference io/work packet split, master.cpp:1421)
        # — unless the op was constructed with an explicit batch= override.
        batched_call = n.effective_batch() > 1
        if batched_call and n.batch is None:
            batch = max(1, min(n.effective_batch(),
                               int(getattr(jr, "work_packet_size",
                                           n.effective_batch()))))
        else:
            batch = max(1, n.effective_batch())

        # Bucketed dispatch: device-placed batched kernels are called at
        # a small ladder of batch sizes (pad by edge-repeating the last
        # row, slice the padding off after), the calling convention the
        # JAX package uses.  Host/python kernels keep exact shapes, and
        # so do stateful kernels: padding rows would advance their state
        # past the real stream position.
        use_buckets = (batched_call and not n.spec.is_stateful
                       and n.effective_device() == DeviceType.TPU)
        ladder = bucket_ladder(batch) if use_buckets else None

        # Device staging: a device kernel gets its inputs moved host->device
        # ONCE per task column (async, whole batch); a host kernel gets
        # device inputs fetched once.  Updated in the store so sibling
        # consumers of the same column reuse the placement.  The target is
        # THIS instance's assigned device, and a batch the loader
        # pre-staged for this instance is already there (to_device no-ops
        # instead of copying across cards).
        is_device_kernel = (n.effective_device() == DeviceType.TPU
                            and self.stage)
        for i, (c, b) in enumerate(zip(in_cols, in_batches)):
            if is_device_kernel and isinstance(b.data, np.ndarray) \
                    and b.data.dtype != object:
                b = b.to_device(ki.device)
            elif not is_device_kernel:
                b = b.to_host()
            # resolve a pending wire-format conversion (YUV420 staged at
            # 1.5 B/px) exactly once, where the data now lives: torch on
            # the device for device kernels, or the bit-identical numpy
            # flavor on host
            if b.convert is not None:
                b = b.converted()
            in_batches[i] = b
            store[(c.op.id, c.column)] = b

        compute = np.asarray(ts.compute_rows, np.int64)
        out_cols = [c for c, _ in n.spec.output_columns]
        valid_out = np.asarray(ts.valid_output_rows, np.int64)
        valid_set = set(valid_out.tolist())

        # A carry plan (unbounded-state node whose recompute starts past
        # row 0) is only sound if THIS kernel instance's state sits
        # exactly at the preceding row of the same stream; anything else
        # (reordered tasks, a failed predecessor, another instance) and
        # maybe_reset would silently reset mid-stream — wrong results.
        # Fail to the self-contained fallback instead.
        # (bind_stream above already rebound+reset on any stream change,
        # nulling _last_row — so the position check alone covers foreign
        # streams, reordering, and failed predecessors)
        if n.spec.unbounded_state and len(compute) and int(compute[0]) > 0:
            if ki._last_row != int(compute[0]) - 1:
                raise StateCarryMiss(
                    f"{n.name}: carry plan expects state at row "
                    f"{int(compute[0]) - 1} of stream "
                    f"({plan.job_idx}, {plan.slice_group}); instance is "
                    f"at {ki._last_row}")

        # window positions per compute row per input column (REPEAT_EDGE)
        sten = np.asarray(stencil, np.int64)
        win_rows = np.clip(compute[:, None] + sten[None, :], 0, max_in - 1)
        col_pos = [b.positions(win_rows.reshape(-1)).reshape(win_rows.shape)
                   for b in in_batches]

        # null propagation: a row whose inputs (or stencil window) contain a
        # null yields null without running the kernel
        null_in = np.zeros(len(compute), bool)
        for b, pos in zip(in_batches, col_pos):
            if b.nulls is not None:
                null_in |= b.nulls[pos].any(axis=1)

        # Under bucketed dispatch a sparse null must not shrink the call
        # shape (every distinct "live subset" size would mint an
        # executable): run the FULL chunk and overwrite dead rows with
        # NullElement afterward.  Safe only when every nulled input is
        # array data (null positions hold valid zero rows); an object
        # column holds NullElement objects the kernel would choke on, so
        # those rare chunks call on the live subset — still padded up to
        # a bucket below, so shapes stay ladder-bounded either way.
        mask_nulls = use_buckets and all(
            b.nulls is None or is_array_data(b.data) for b in in_batches)

        # contiguous runs of compute rows; reset state between runs
        run_bounds: List[Tuple[int, int]] = []
        start = 0
        for i in range(1, len(compute) + 1):
            if i == len(compute) or compute[i] != compute[i - 1] + 1:
                run_bounds.append((start, i))
                start = i
        out_parts: Dict[str, List[ColumnBatch]] = {c: [] for c in out_cols}

        def emit(col: str, rows: np.ndarray, data, per_row: bool) -> None:
            """Append kernel results, dropping warmup rows."""
            keep = np.isin(rows, valid_out)
            if not keep.any():
                return
            if per_row:
                kept = [d for d, k in zip(data, keep) if k]
                out_parts[col].append(
                    ColumnBatch.from_elements(rows[keep], kept))
            else:
                if keep.all():
                    out_parts[col].append(ColumnBatch(rows, data))
                else:
                    idx = np.flatnonzero(keep)
                    out_parts[col].append(
                        ColumnBatch(rows[keep], _index(data, idx)))

        def emit_result(rows: np.ndarray, res) -> None:
            """Dispatch one kernel call's result to output columns.

            Multi-output batch kernels may return either a tuple of
            per-column batches or a list of per-row tuples (the classic
            protocol) — both are accepted."""
            if len(out_cols) == 1:
                cols_res = (res,)
            elif isinstance(res, tuple) and len(res) == len(out_cols):
                cols_res = res
            elif (isinstance(res, list) and len(res) == len(rows)
                  and all(isinstance(r, tuple) and len(r) == len(out_cols)
                          for r in res)):
                cols_res = tuple(list(col) for col in zip(*res))
            else:
                raise JobException(
                    f"{n.name}: expected {len(out_cols)}-tuple output")
            for col, r in zip(out_cols, cols_res):
                if is_array_data(r) and len(r) == len(rows):
                    emit(col, rows, r, per_row=False)
                else:
                    if r is None or len(r) != len(rows):
                        raise JobException(
                            f"{n.name}: batch kernel returned "
                            f"{0 if r is None else len(r)} results "
                            f"for {len(rows)} inputs")
                    emit(col, rows, list(r), per_row=True)

        null_out_rows: List[int] = []

        def null_rows(rows: np.ndarray) -> None:
            keep = np.isin(rows, valid_out)
            if keep.any():
                null_out_rows.extend(rows[keep].tolist())

        def call_args_for(sel: np.ndarray) -> List[Any]:
            """Kernel arguments for compute positions `sel` (indices into
            the compute/col_pos arrays): per input column either a
            (k, ...) batch slice, a (k, W, ...) stencil gather, or per-row
            python objects."""
            args = []
            for b, pos in zip(in_batches, col_pos):
                p = pos[sel]           # (k, W)
                if is_array_data(b.data):
                    if has_stencil:
                        args.append(_index(b.data, p.reshape(-1)).reshape(
                            p.shape + tuple(b.data.shape[1:])))
                    else:
                        q = p[:, 0]
                        if len(q) and np.array_equal(
                                q, np.arange(q[0], q[0] + len(q))):
                            args.append(b.data[q[0]:q[0] + len(q)])
                        else:
                            args.append(_index(b.data, q))
                else:
                    if has_stencil:
                        args.append([[b.data[int(j)] for j in row]
                                     for row in p])
                    else:
                        args.append([b.data[int(j)] for j in p[:, 0]])
            return args

        t0 = time.time()
        try:
            with self.profiler.span("evaluate:" + n.name,
                                    rows=len(compute)):
                for lo, hi in run_bounds:
                    ki.maybe_reset(int(compute[lo]))
                    ki._last_row = int(compute[hi - 1])
                    i = lo
                    while i < hi:
                        j = min(i + batch, hi)
                        sel = np.arange(i, j)
                        dead = sel[null_in[sel]]
                        if len(dead):
                            null_rows(compute[dead])
                        if mask_nulls and len(dead) < len(sel):
                            # full-chunk call; dead rows' outputs are
                            # overwritten with nulls at assembly time
                            live = sel
                        else:
                            live = sel[~null_in[sel]]
                        if not len(live):
                            i = j
                            continue
                        if batched_call:
                            exec_sel, pad = live, 0
                            if use_buckets:
                                pad = bucket_for(len(live),
                                                 ladder) - len(live)
                                if pad:
                                    exec_sel = np.concatenate(
                                        [live,
                                         np.repeat(live[-1:], pad)])
                                    _M_OP_PAD_ROWS.labels(
                                        op=n.name,
                                        device=ki.dev_label).inc(pad)
                            args = call_args_for(exec_sel)
                            # a never-seen arg (device, shape, dtype)
                            # signature: counted, and marked on the op
                            # span (the ladder bounds them per device)
                            sig = (ki.dev_label,) + tuple(
                                (tuple(a.shape), str(a.dtype))
                                if is_array_data(a) else len(a)
                                for a in args)
                            if sig not in ki._shape_sigs:
                                ki._shape_sigs.add(sig)
                                _M_OP_SHAPES.labels(
                                    op=n.name,
                                    device=ki.dev_label).inc()
                                _tracing.add_event(
                                    "op.new_shape", op=n.name,
                                    device=ki.dev_label)
                            res = ki.kernel.execute(*args)
                            if pad:
                                res = _strip_pad(res, len(live),
                                                 len(out_cols))
                            emit_result(compute[live], res)
                        else:
                            args = call_args_for(live)
                            row_args = []
                            for a in args:
                                e = a[0]
                                if has_stencil and is_array_data(a):
                                    e = list(a[0])
                                row_args.append(e)
                            res = ki.kernel.execute(*row_args)
                            emit_result(compute[live], _single(res, n, out_cols))
                        i = j
        except BaseException as e:
            # the kernel died mid-run: its internal state is partial and
            # _last_row may already claim the run's end.  Reset both so a
            # subsequent carry plan MISSES (fallback) instead of silently
            # continuing from half-advanced state, and a self-contained
            # re-run starts from a clean reset.
            if ki.spec.is_stateful:
                try:
                    ki.kernel.reset()
                finally:
                    ki._last_row = None
            raise
        _M_OP_ROWS.labels(op=n.name).inc(len(compute))
        _M_OP_SECONDS.labels(op=n.name).inc(time.time() - t0)

        # assemble output columns in row order; null-propagated rows (rare)
        # interleave with kernel results, so columns containing them fall
        # back to per-element assembly
        null_set = set(null_out_rows)
        outputs: Dict[str, ColumnBatch] = {}
        for col in out_cols:
            parts = out_parts[col]
            if not parts and not null_set:
                outputs[col] = ColumnBatch(np.zeros(0, np.int64), [])
                continue
            if null_set:
                by_row: Dict[int, Elem] = {}
                for p in parts:
                    for r, e in zip(p.rows.tolist(), p.elements()):
                        by_row[r] = e
                # nulls LAST so they win: bucketed dispatch runs dead
                # rows through the kernel (full-chunk shape) and their
                # outputs must be discarded here
                for r in null_set:
                    by_row[int(r)] = NullElement()
                rows_sorted = np.asarray(sorted(by_row), np.int64)
                outputs[col] = ColumnBatch.from_elements(
                    rows_sorted, [by_row[int(r)] for r in rows_sorted])
            else:
                parts.sort(
                    key=lambda p: int(p.rows[0]) if len(p.rows) else 0)
                outputs[col] = concat_batches(parts)
            got = set(outputs[col].rows.tolist())
            if got != valid_set:
                missing = sorted(valid_set - got)
                raise JobException(
                    f"{n.name}: missing output rows {missing[:5]}...")
        return outputs


def _single(res, n, out_cols):
    """Wrap a batch=1 result to per-row list form for emit_result."""
    if len(out_cols) == 1:
        return [res]
    if not isinstance(res, tuple) or len(res) != len(out_cols):
        raise JobException(
            f"{n.name}: expected {len(out_cols)}-tuple output")
    return tuple([v] for v in res)
