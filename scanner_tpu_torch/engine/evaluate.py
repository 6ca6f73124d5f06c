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
stay numpy and device kernels run their host flavors.  A model kernel
replicates over the instance's partition of the host's cards
(`instance_devices`): every card when one instance runs.  There is no probe
and no fallback: asking for "cuda" without a card raises.

Bucketed dispatch: device-kernel calls are rounded up a small power-of-two
bucket ladder (`bucket_ladder`).  A tail chunk pads up to the next bucket
by edge-repeating its last row (the REPEAT_EDGE convention stencils
already use) and the padding is sliced off before results are emitted;
null-propagated rows ride through the call at the full chunk shape and
are overwritten with NullElement afterward.  The JAX package does this so
that XLA compiles a bounded executable set; here the ladder bounds the
CUDA graphs a fused chain captures (one per bucket), and both packages
make the same kernel calls.  Host/python kernels keep exact shapes, and
stateful kernels do too (padding rows would advance their state).
`TaskEvaluator(precompile=...)` warms each device op's ladder on a
background thread — a real call per rung, which builds and binds the
kernel library, fills its per-card caches and captures each chain's
graphs — overlapped with the first task's load.

Fusion (graph/fusion.py): a planned chain of device ops runs as ONE
call at its tail node.  On a card that call replays a CUDA graph
captured per (bucket, input signature, stream args): the members'
`execute_traced` bodies composed head to tail, their launches recorded
once and replayed with one host call.  On the CPU the same composition
runs eagerly."""

from __future__ import annotations

import os
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common import (DeviceType, JobException, NullElement,
                      ScannerException, SliceList)
from ..graph import analysis as A
from ..graph import fusion as _fusion
from ..graph import ops as O
from ..util import coststats as _cs
from ..util import memstats as _ms
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
_M_OP_PRECOMPILE = _mx.registry().gauge(
    "scanner_tpu_op_precompile_seconds",
    "Seconds the setup-time warm-up spent running this device op's "
    "(or fused chain's) bucket ladder on its assigned device "
    "(overlapped with the first task's load).",
    labels=["op", "device"])
_M_GRAPH_CAPTURES = _mx.registry().counter(
    "scanner_tpu_fusion_graph_captures_total",
    "CUDA graphs captured for fused chains, per chain id and device: "
    "one per (bucket, input signature, stream args).",
    labels=["chain", "device"])
_M_GRAPH_REPLAYS = _mx.registry().counter(
    "scanner_tpu_fusion_graph_replays_total",
    "Fused-chain calls served by replaying a captured CUDA graph, per "
    "chain id and device.",
    labels=["chain", "device"])

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


def kernel_devices(device: torch.device) -> List[torch.device]:
    """The devices kernels of a client on `device` may use: on CUDA
    every card of the host, starting at `device` (cards device.index,
    device.index + 1, ... mod n); on the CPU just `device`."""
    if device.type != "cuda":
        return [device]
    n = torch.cuda.device_count()
    return [torch.device("cuda", (device.index + k) % n) for k in range(n)]


def assigned_device(device: torch.device, instance: int) -> torch.device:
    """The device pipeline instance `instance` owns: card
    (device.index + instance) mod n on CUDA (with one card, every
    instance owns cuda:0), the CPU otherwise.  Used by both the
    evaluator and the executor (TaskItem device assignment at enqueue
    time): one mapping, two sides of the handoff."""
    devs = kernel_devices(device)
    return devs[instance % len(devs)]


def instance_devices(device: torch.device, instance: int,
                     instances: int = 1) -> List[torch.device]:
    """The devices pipeline instance `instance` of `instances` hands its
    model kernels (their DataParallelApply replicas).  One instance
    keeps every card of the host; N instances partition them, so
    concurrent instances never replicate onto each other's cards: every
    N-th card from the instance's own, or that one card when there are
    more instances than cards.  A partition leads with
    assigned_device(device, instance), so the evaluator and the
    executor agree."""
    devs = kernel_devices(device)
    if instances <= 1 or len(devs) <= 1:
        return devs
    if instances <= len(devs):
        return devs[instance::instances]
    return [devs[instance % len(devs)]]


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


# the one implementation lives with the memory accountant, so metrics,
# ledger entries and trace attrs key devices identically
device_label = _ms.device_label


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


def _precompile_enabled(device: torch.device) -> bool:
    """Ladder warm-up default: on for an evaluator on a card (where a
    first call builds the kernel library and captures graphs), off on
    the CPU (nothing to build, and tests construct many evaluators).
    SCANNER_TPU_PRECOMPILE=1/0 forces either way."""
    flag = os.environ.get("SCANNER_TPU_PRECOMPILE", "")
    if flag in ("0", "false"):
        return False
    if flag in ("1", "force", "true"):
        return True
    return device.type == "cuda"


def _source_geometry_inputs(node: O.OpNode) -> bool:
    """True when every FRAME input of `node` reaches an Input node
    through builtins only (gathers never change frame geometry), so the
    ladder warm-up's synthesized frames have the source's shape.  An
    intervening kernel (Resize/CropResize/...) may change geometry; its
    consumers skip warm-up rather than warm a wrong-shape ladder — and
    their first real call pays it, behind ensure_warm."""
    for c in node.input_columns():
        if not c.is_frame:
            continue
        p = c.op
        while p.is_builtin and p.name != O.INPUT_OP:
            cols = p.input_columns()
            if not cols:
                return False
            p = cols[0].op
        if p.name != O.INPUT_OP:
            return False
    return True


def _strip_pad(res, k: int, n_out: int):
    """Drop bucket-padding rows from a kernel result before emission.
    Accepts every result protocol _Outputs.result does: a single batch, a
    tuple of per-column batches, or a list of per-row results/tuples."""
    if n_out > 1 and isinstance(res, tuple) and len(res) == n_out:
        return tuple(r[:k] for r in res)
    try:
        return res[:k]
    except TypeError:
        return res  # malformed result: let _Outputs.result raise its error


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
                 device: Optional[Any] = None, staged: bool = False):
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
        # kernels.  `staged`: its frame inputs arrive as tensors there.
        self.device = device
        self.staged = staged
        self.dev_label = device_label(device)
        self._cur_stream: Tuple[int, int] = (-1, -1)  # (job, slice group)
        self._last_row: Optional[int] = None
        self._did_setup = False
        # input (device, shape, dtype) signatures already executed
        self._shape_sigs: set = set()
        # bucket-ladder warm-up state: idle (not scheduled) | pending
        # (scheduled, not started) | running | done
        self._warm_lock = threading.Lock()
        self._warm_state = "idle"
        self._warm_done = threading.Event()
        # serializes kernel.execute between the evaluation thread and a
        # warm-up thread: two concurrent execute() calls on one kernel
        # instance are not guaranteed safe, and the ensure_warm
        # handshake alone cannot cover a mid-run rewarm.  Uncontended
        # in steady state.
        self._call_lock = threading.Lock()

    def setup(self, fetch: bool = True) -> None:
        if not self._did_setup:
            if fetch:
                self.kernel.fetch_resources()
            self.kernel.setup_with_resources()
            self._did_setup = True

    def stream_args(self, job_idx: int, slice_group: int) -> dict:
        """The per-stream kwargs new_stream would receive for this
        (job, slice group) — also part of a fused chain's graph key
        (e.g. Resize takes its output geometry from them)."""
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

    # -- bucket-ladder warm-up (precompile) ----------------------------

    def _example_args(self, b: int, h: int, w: int) -> Optional[List[Any]]:
        """Synthesized execute() args at batch size `b` for warm-up:
        frame columns get (b[, W], h, w, 3) uint8 zeros — a tensor on
        this instance's device when its inputs are staged there, else
        numpy — and non-frame columns come from the kernel's optional
        `precompile_input(name)` hook.  None = this op is not
        generically warmable (variadic, or a non-frame input without a
        hook)."""
        if self.spec.variadic:
            return None
        sten = self.node.effective_stencil()
        win = len(sten) if sten != [0] else 0
        args: List[Any] = []
        for name, is_frame in self.spec.input_columns:
            if is_frame:
                shape = (b, win, h, w, 3) if win else (b, h, w, 3)
                args.append(_zeros(shape, self.device if self.staged
                                   else None, self.dev_label))
            else:
                row = self.kernel.precompile_input(name)
                if row is None:
                    return None
                args.append([[row] * win for _ in range(b)] if win
                            else [row] * b)
        return args

    def precompile(self, ladder: Sequence[int], h: int, w: int) -> None:
        """Run this kernel at every ladder bucket (best-effort: a failing
        warm-up shape is skipped; the real call then pays it).  Runs on
        the evaluator's warm-up thread; ensure_warm() on the evaluation
        thread claims or waits."""
        with self._warm_lock:
            if self._warm_state != "pending":
                return  # claimed by a real call racing ahead of us
            self._warm_state = "running"
        t0 = time.time()
        try:
            # job 0's stream args first (Resize takes its geometry from
            # them); the real dispatch rebinds only if its stream differs
            self.bind_stream(0, 0)
            for b in ladder:
                args = self._example_args(b, h, w)
                if args is None:
                    return
                try:
                    # compile ledger: a library build at this rung is
                    # attributed to (op, device, bucket)
                    with self._call_lock, \
                            _cs.observe_compiles(self.node.name,
                                                 self.dev_label, b,
                                                 f"warmup:b{b}"):
                        self.kernel.execute(*args)
                except Exception:  # noqa: BLE001 — warm-up is best-effort
                    _log.warning("warm-up of %s at batch %d failed",
                                 self.node.name, b, exc_info=True)
                    return
            _M_OP_PRECOMPILE.labels(op=self.node.name,
                                    device=self.dev_label).set(
                time.time() - t0)
        finally:
            with self._warm_lock:
                self._warm_state = "done"
            self._warm_done.set()

    def ensure_warm(self) -> None:
        """Called before a real execute(): if this kernel's warm-up is
        mid-flight, wait for it; if it has not started yet, claim it so
        the warm-up thread skips this kernel."""
        with self._warm_lock:
            if self._warm_state == "pending":
                self._warm_state = "done"
                self._warm_done.set()
                return
            if self._warm_state != "running":
                return
        self._warm_done.wait()

    def close(self) -> None:
        self.kernel.close()


def _zeros(shape, device: Optional[torch.device], label: str):
    """Warm-up frames: uint8 zeros made on `device` (tracked in the
    allocation ledger as "warmup"), or numpy zeros for host calls."""
    if device is None:
        return np.zeros(shape, np.uint8)
    t = torch.zeros(shape, dtype=torch.uint8, device=device)
    _ms.track_array(t, "warmup", device=label)
    return t


def _sig_key(shape, dtype) -> Tuple:
    """(shape, dtype name) of a numpy array or a tensor alike."""
    return tuple(shape), str(dtype).replace("torch.", "")


class _ChainGraph:
    """One captured CUDA graph of a fused chain: its static input and
    output tensors, and the [launches, id launches] of the histogram
    kernel one replay makes (cuda_ops.capture_launches)."""

    __slots__ = ("graph", "static_in", "static_out", "launches")

    def __init__(self, graph, static_in, static_out, launches):
        self.graph = graph
        self.static_in = static_in
        self.static_out = static_out
        self.launches = launches


class _ChainGraphs:
    """The CUDA graphs of one chain program on one card and stream, one
    per input signature (bucket), all in one memory pool.  A call copies
    in, replays and clones out under `lock`: graphs that share a pool
    must never have two replays in flight between a replay and the clone
    of its output."""

    def __init__(self):
        self.pool = torch.cuda.graph_pool_handle()
        self.lock = threading.Lock()
        self.graphs: Dict[Tuple, _ChainGraph] = {}


# process-wide, keyed on everything a capture bakes in — each member's
# op, kernel class, init args, stream-bound args and window, and the
# card and stream — the way the JAX package keeps its chain programs
# (_CHAIN_PROGRAMS): evaluators are built per job, and graphs kept per
# evaluator would be captured, each into a fresh memory pool, again by
# every job
_CHAIN_GRAPHS: Dict[Tuple, _ChainGraphs] = {}
_CHAIN_GRAPHS_LOCK = threading.Lock()


class FusedKernelInstance:
    """One planned fusion chain (graph/fusion.py) run as a SINGLE call:
    the member kernels' `execute_traced` bodies composed head to tail,
    dispatched at the TAIL node with ONE bucket ladder for the whole
    chain.  On a card each (bucket, input signature, stream args) is
    captured once per process as a CUDA graph (_CHAIN_GRAPHS) and every
    later call — of this job or a later one — replays it: one host call
    in place of the members' dozens of small launches.  On the CPU the
    composition runs eagerly.

    Mirrors KernelInstance's warm-up/call-lock protocol so the
    evaluator's precompile thread, ensure_warm handshake and rewarm
    treat chains and single kernels uniformly.  All attribution
    (recompile proxy, pad rows, compile ledger, op rows/seconds,
    roofline) keys on the stable chain id `"a+b+c"`."""

    def __init__(self, chain: "_fusion.FusionChain",
                 members: List[KernelInstance]):
        self.chain = chain
        self.members = members
        self.chain_id = chain.chain_id
        self.member_names = chain.member_names
        self.head = members[0]
        self.tail = members[-1]
        # all members share this evaluator instance's device (the
        # planner only fuses device ops, all pinned to that device)
        self.device = self.tail.device
        self.staged = self.tail.staged
        self.dev_label = self.tail.dev_label
        # per member, head->tail: window length (0 = no window axis)
        self.windows = chain.windows()
        self.stencils = [np.asarray(s, np.int64) for s in chain.stencils()]
        self.width = chain.width()
        # current stream-bound args per member (set by bind_stream) and
        # the program key they make with the members' identities: part of
        # every graph key, so a rebind that changes them maps to other
        # graphs
        self._stream_args: Optional[List[dict]] = None
        self.program_key: Tuple = ()
        self.bind_args([{} for _ in members])
        self._shape_sigs: set = set()
        # (shape, dtype) of the head input -> each member's input shape
        # (recorded when the composition runs) and the chain's cost
        self._member_shapes: Dict[Tuple, List[tuple]] = {}
        self._cost_cache: Dict[Tuple, Tuple] = {}
        self._warm_lock = threading.Lock()
        self._warm_state = "idle"
        self._warm_done = threading.Event()
        self._call_lock = threading.Lock()

    # -- the fused call ------------------------------------------------

    def _chain_fn(self, y: torch.Tensor) -> torch.Tensor:
        """The whole chain on a (k * width, ...) composed-window gather
        of the head's input: each windowed member folds its own window
        axis out of the leading dimension — compose_positions laid
        positions out with the HEAD's window innermost, so the
        progressive reshape walks the nesting exactly."""
        key = _sig_key(y.shape, y.dtype)
        shapes = []
        for ki, win in zip(self.members, self.windows):
            if win:
                y = y.reshape((y.shape[0] // win, win) + tuple(y.shape[1:]))
            shapes.append(tuple(y.shape))
            y = ki.kernel.execute_traced(y)
        self._member_shapes[key] = shapes
        return y

    def _capture(self, x: torch.Tensor, pool) -> _ChainGraph:
        """Capture the chain at x's signature as a CUDA graph in `pool`.
        One eager run on a side stream first does the first-use work a
        capture must not hold (the kernel library's build, its per-card
        caches, the resampler bands' upload).  A capture that fails
        raises."""
        from ..kernels import cuda_ops
        t0 = time.time()
        dev = x.device
        static_in = torch.empty_like(x)
        static_in.copy_(x)
        _ms.track_array(static_in, "graph", device=self.dev_label)
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._chain_fn(static_in)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # capture_begin/capture_end, not the torch.cuda.graph context: it
        # would synchronize the card, collect garbage and empty the
        # allocator's cache around every capture, none of which a
        # capture on a stream of its own needs.  thread_local: loader
        # threads keep staging (pinned copies) on other streams while
        # this thread captures.
        with cuda_ops.capture_launches() as launches, \
                torch.cuda.stream(side):
            graph.capture_begin(pool=pool,
                                capture_error_mode="thread_local")
            try:
                out = self._chain_fn(static_in)
            finally:
                graph.capture_end()
        if not isinstance(out, torch.Tensor):
            raise JobException(f"{self.chain_id}: the chain's tail returned "
                               f"{type(out).__name__}, not a tensor")
        _cs.note_compile(time.time() - t0, "uncached", "graph")
        _M_GRAPH_CAPTURES.labels(chain=self.chain_id,
                                 device=self.dev_label).inc()
        return _ChainGraph(graph, static_in, out, tuple(launches))

    def execute(self, arr):
        """One fused call, then the tail's host-side finish().  On a card:
        the chunk is copied into the graph's static input, the graph
        replays, and finish() gets a CLONE of the static output (the
        column store holds results until the sink; the next replay
        overwrites the static output)."""
        x = arr if isinstance(arr, torch.Tensor) \
            else torch.from_numpy(np.ascontiguousarray(arr))
        if self.staged:
            x = x.to(self.device)
        if x.device.type != "cuda":
            return self.tail.kernel.finish(self._chain_fn(x))
        from ..kernels import cuda_ops
        key = (self.program_key, x.device.index,
               torch.cuda.current_stream(x.device).cuda_stream)
        with _CHAIN_GRAPHS_LOCK:
            cg = _CHAIN_GRAPHS.get(key)
            if cg is None:
                cg = _CHAIN_GRAPHS[key] = _ChainGraphs()
        with cg.lock:
            sig = (tuple(x.shape), x.dtype)
            g = cg.graphs.get(sig)
            if g is None:
                g = cg.graphs[sig] = self._capture(x, cg.pool)
            g.static_in.copy_(x)
            g.graph.replay()
            out = g.static_out.clone()
        cuda_ops.count_replay(g.launches)
        _M_GRAPH_REPLAYS.labels(chain=self.chain_id,
                                device=self.dev_label).inc()
        return self.tail.kernel.finish(out)

    def bind_stream(self, job_idx: int, slice_group: int) -> None:
        for ki in self.members:
            ki.bind_stream(job_idx, slice_group)
        self.bind_args([ki.stream_args(job_idx, slice_group)
                        for ki in self.members])

    def bind_args(self, sargs: List[dict]) -> None:
        """Record the members' stream-bound args and the program key."""
        if sargs != self._stream_args:
            self._stream_args = sargs
            self.program_key = tuple(
                (ki.spec.name,
                 f"{type(ki.kernel).__module__}."
                 f"{type(ki.kernel).__qualname__}",
                 repr(sorted(ki.node.init_args.items())),
                 repr(sorted(a.items())), win)
                for ki, a, win in zip(self.members, sargs, self.windows))

    def compose_positions(self, rows: np.ndarray, max_in: int) -> np.ndarray:
        """Head-input read positions for tail compute rows `rows`: the
        member stencils composed tail-first, REPEAT_EDGE-clamped at
        EVERY level — exactly the staged pipeline's transitive backward
        dilation (graph/analysis.py derive_task_streams), so the fused
        gather reads precisely the rows the staged members would have.
        Returns a flat (len(rows) * width,) position array."""
        pos = np.asarray(rows, np.int64)
        for sten, win in zip(reversed(self.stencils),
                             reversed(self.windows)):
            if win:
                pos = np.clip(pos[:, None] + sten[None, :], 0,
                              max_in - 1).reshape(-1)
        return pos

    # -- chain cost model ----------------------------------------------

    def cost_for(self, shape, dtype):
        """Analytical chain descriptor for a head-input signature:
        member costs summed over the member input shapes the
        composition saw at this signature, with bytes_in/bytes_out taken
        at the chain BOUNDARY (the fused call reads the head input and
        writes the tail output).  Also returns the member intermediate
        bytes fusion kept off separate calls (every non-tail output +
        every non-head input).  (None, 0.0) when any member lacks a cost
        model or the signature never ran."""
        key = _sig_key(shape, dtype)
        hit = self._cost_cache.get(key)
        if hit is not None:
            return hit
        shapes = self._member_shapes.get(key)
        if shapes is None:
            return None, 0.0
        desc, saved = None, 0.0
        descs = []
        for ki, shp in zip(self.members, shapes):
            d = ki.kernel.cost([shp])
            if isinstance(d, dict):
                d = _cs.CostDescriptor(**d)
            descs.append(d)
        if all(d is not None for d in descs):
            desc = _cs.CostDescriptor(
                flops=sum(float(d.flops or 0.0) for d in descs),
                bytes_in=descs[0].bytes_in,
                bytes_out=descs[-1].bytes_out,
                source="hook")
            saved = (sum(float(d.bytes_out or 0.0) for d in descs[:-1])
                     + sum(float(d.bytes_in or 0.0) for d in descs[1:]))
        self._cost_cache[key] = (desc, saved)
        return desc, saved

    # -- chain batch cap / warm-up -------------------------------------

    def cap_for(self, wp: Optional[int]) -> int:
        """Per-call batch cap for the CHAIN: walking tail->head, member
        i runs at (tail rows x its downstream window expansion) rows
        per call, so its own cap (the same work-packet derivation as
        _run_kernel) divides down by that expansion.  The chain takes
        the tightest bound — no member ever sees a call larger than it
        would have accepted staged."""
        cap = None
        exp = 1
        for ki, win in zip(reversed(self.members),
                           reversed(self.windows)):
            n = ki.node
            if n.batch is None and wp:
                mcap = max(1, min(n.effective_batch(), int(wp)))
            else:
                mcap = max(1, n.effective_batch())
            c = max(1, mcap // max(1, exp))
            cap = c if cap is None else min(cap, c)
            exp *= max(win, 1)
        return max(1, cap if cap is not None else 1)

    def warmable(self) -> bool:
        """Generic warm-up synthesizes head frames at source geometry:
        needs a frame head input reachable from Input through builtins
        only (same eligibility as single-kernel warm-up)."""
        n = self.head.node
        return bool(n.spec.input_columns
                    and n.spec.input_columns[0][1]
                    and _source_geometry_inputs(n))

    def precompile(self, ladder: Sequence[int], h: int, w: int) -> None:
        """Run the chain at every chain-ladder bucket — on a card, each
        run captures that bucket's graph (one ladder for the WHOLE
        chain: the warm-up the staged path would have run per
        member)."""
        with self._warm_lock:
            if self._warm_state != "pending":
                return
            self._warm_state = "running"
        t0 = time.time()
        try:
            # bind job-0 stream args first: members like Resize get
            # their geometry from new_stream, and the real dispatch
            # rebinds only if its (job, slice group) differs, so the
            # warmed graphs serve the first call
            self.bind_stream(0, 0)
            for b in ladder:
                arr = _zeros((b * self.width, h, w, 3),
                             self.device if self.staged else None,
                             self.dev_label)
                try:
                    with self._call_lock, \
                            _cs.observe_compiles(self.chain_id,
                                                 self.dev_label, b,
                                                 f"warmup:b{b}",
                                                 members=self.member_names):
                        self.execute(arr)
                except Exception:  # noqa: BLE001 — the real call raises
                    _log.warning("warm-up of chain %s at batch %d failed",
                                 self.chain_id, b, exc_info=True)
                    return
            _M_OP_PRECOMPILE.labels(op=self.chain_id,
                                    device=self.dev_label).set(
                time.time() - t0)
        finally:
            with self._warm_lock:
                self._warm_state = "done"
            self._warm_done.set()

    def ensure_warm(self) -> None:
        """Same handshake as KernelInstance.ensure_warm."""
        with self._warm_lock:
            if self._warm_state == "pending":
                self._warm_state = "done"
                self._warm_done.set()
                return
            if self._warm_state != "running":
                return
        self._warm_done.wait()


# every live TaskEvaluator, weakly held, so a ladder re-warm can reach
# them process-wide through rewarm_all() without owning their lifetimes
_LIVE_EVALUATORS: "weakref.WeakSet" = weakref.WeakSet()


def rewarm_all() -> int:
    """Re-schedule the bucket-ladder warm-up on every live evaluator.
    Returns the total number of kernels scheduled; an evaluator failing
    to re-warm is logged, never raised."""
    total = 0
    for te in list(_LIVE_EVALUATORS):
        try:
            total += te.rewarm()
        except Exception:  # noqa: BLE001 — re-warm is best-effort
            _log.exception("ladder re-warm failed for an evaluator")
    return total


class TaskEvaluator:
    def __init__(self, info: A.GraphInfo, profiler: Profiler,
                 device: torch.device,
                 stage: Optional[bool] = None,
                 skip_fetch_resources: bool = False,
                 precompile: Optional[Tuple[int, int, int]] = None,
                 instance: int = 0, instances: int = 1,
                 devices: Optional[List[Any]] = None):
        """`device` is the client's device.  `stage` says whether device
        kernels' input columns are staged onto this instance's device as
        tensors; it defaults to True exactly when that is a CUDA card.
        `precompile` is a (frame_h, frame_w, work_packet_size) hint for
        the bucket-ladder warm-up (the engine's geometry is not knowable
        from the graph alone).  Device kernels see `devices` (their
        KernelConfig.devices: the replicas of a model kernel's
        DataParallelApply), by default this instance's partition of
        the host's cards (instance_devices); stdlib staging and calls
        stay on the instance's own device."""
        self.info = info
        self.profiler = profiler
        self.instance = instance
        self.device = assigned_device(device, instance)
        if devices is None:
            devices = instance_devices(device, instance, instances)
        self.stage = (self.device.type == "cuda") if stage is None \
            else bool(stage)
        self.kernels: Dict[int, KernelInstance] = {}
        for n in info.ops:
            if not n.is_builtin:
                on_dev = n.effective_device() == DeviceType.TPU
                self.kernels[n.id] = KernelInstance(
                    n, profiler, list(devices) if on_dev else None,
                    device=self.device if on_dev else None,
                    staged=on_dev and self.stage)
        for ki in self.kernels.values():
            ki.setup(fetch=not skip_fetch_resources)
        # whole-pipeline fusion (graph/fusion.py): maximal runs of
        # fusable consecutive device ops execute as ONE call.  Non-tail
        # members never dispatch (or materialize an output column) on
        # their own — the tail node runs the whole chain.
        self.chains: Dict[int, "_fusion.FusionChain"] = {}
        self.fused: Dict[int, FusedKernelInstance] = {}
        self._chain_member_ids: set = set()
        if _fusion.enabled():
            for ch in _fusion.plan_chains(info):
                self.chains[ch.tail.id] = ch
                self.fused[ch.tail.id] = FusedKernelInstance(
                    ch, [self.kernels[m.id] for m in ch.members])
                for m in ch.members[:-1]:
                    self._chain_member_ids.add(m.id)
        # measured calls' timing events, read without a per-call sync
        self._timer = _cs.CallTimer()
        # bucket-ladder warm-up on a background thread, overlapped with
        # the first task's load; evaluation joins per kernel through
        # ensure_warm()
        self._precompile_thread: Optional[threading.Thread] = None
        self._precompile_hint = precompile
        if precompile is not None and _precompile_enabled(self.device):
            targets = self._warm_targets(precompile)
            for ki, _ladder in targets:
                ki._warm_state = "pending"
            self._spawn_warm(targets, precompile)
        _LIVE_EVALUATORS.add(self)

    def _warm_targets(self, precompile: Tuple[int, int, int]
                      ) -> List[Tuple[Any, List[int]]]:
        """The warm-up-eligible kernels and chains with their ladders
        (shared by the constructor's warm-up and rewarm)."""
        _h, _w, wp = precompile
        targets: List[Tuple[Any, List[int]]] = []
        for ki in self.kernels.values():
            n = ki.node
            if n.id in self._chain_member_ids or n.id in self.chains:
                continue  # fused members warm as one chain, below
            if n.effective_device() != DeviceType.TPU \
                    or n.effective_batch() <= 1 \
                    or ki.spec.is_stateful or ki.spec.variadic \
                    or not _source_geometry_inputs(n):
                continue
            # same per-call cap derivation as _run_kernel
            if n.batch is None and wp:
                cap = max(1, min(n.effective_batch(), int(wp)))
            else:
                cap = max(1, n.effective_batch())
            targets.append((ki, bucket_ladder(cap)))
        for fki in self.fused.values():
            if fki.warmable():
                targets.append((fki, bucket_ladder(fki.cap_for(wp))))
        return targets

    def _spawn_warm(self, targets, precompile) -> None:
        if not targets:
            return
        h, w, _wp = precompile
        dev = self.device

        def warm() -> None:
            if dev.type == "cuda":
                torch.cuda.set_device(dev)
            for ki, ladder in targets:
                ki.precompile(ladder, h, w)

        self._precompile_thread = threading.Thread(
            target=warm, name="precompile", daemon=True)
        self._precompile_thread.start()

    def rewarm(self) -> int:
        """Re-schedule the bucket-ladder warm-up: kernels whose warm-up
        is idle or done go back to pending and a fresh warm-up thread
        runs their ladders again.  Mid-flight warm-ups and claims by
        racing real calls are respected (the same ensure_warm /
        _call_lock handshake as construction).  Returns the number of
        kernels scheduled."""
        hint = self._precompile_hint
        if hint is None or not _precompile_enabled(self.device):
            return 0
        claimed: List[Tuple[Any, List[int]]] = []
        for ki, ladder in self._warm_targets(hint):
            with ki._warm_lock:
                if ki._warm_state in ("idle", "done"):
                    ki._warm_state = "pending"
                    ki._warm_done.clear()
                    claimed.append((ki, ladder))
        self._spawn_warm(claimed, hint)
        return len(claimed)

    def close(self) -> None:
        _LIVE_EVALUATORS.discard(self)
        self._timer.resolve(wait=True)
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
            if n.id in self._chain_member_ids:
                # fused into a chain: the tail node dispatches the whole
                # chain, this member never materializes an output column
                continue
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
            elif n.id in self.chains:
                outs = self._run_fused(n, jr, plan, store)
                for col, b in outs.items():
                    store[(n.id, col)] = b
            else:
                outs = self._run_kernel(n, jr, plan, store)
                for col, b in outs.items():
                    store[(n.id, col)] = b
            self.last_peak_columns = max(self.last_peak_columns, len(store))
            if n.id in self.chains:
                # the whole chain's input edges are consumed here: every
                # member's reads happen at tail time, and member columns
                # themselves were never stored
                cons_cols = [c for m in self.chains[n.id].members
                             for c in m.input_columns()]
            else:
                cons_cols = n.input_columns()
            for c in cons_cols:
                pid = c.op.id
                remaining[pid] -= 1
                if remaining[pid] == 0:
                    for key in [k for k in store if k[0] == pid]:
                        del store[key]
        self._timer.resolve()
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

    # -- roofline attribution ------------------------------------------

    def _op_call_done(self, op: str, ki: KernelInstance, bucket: int,
                      rows: int, args):
        """The CallTimer callback of one measured call: fold its seconds
        and cost descriptor into the roofline ledger once they are read."""
        desc = _cs.descriptor_for(ki.kernel, op, ki.dev_label, bucket, args)

        def done(seconds: float) -> None:
            _cs.record_op_call(op, ki.dev_label, bucket, rows, seconds, desc)
        return done

    # -- regular kernels -----------------------------------------------

    def _run_kernel(self, n: O.OpNode, jr: A.JobRows, plan: A.TaskPlan,
                    store) -> Dict[str, ColumnBatch]:
        ts = plan.streams[n.id]
        ki = self.kernels[n.id]
        # a warm-up in flight binds the kernel's stream args itself: wait
        # for it (or claim it) before rebinding them
        ki.ensure_warm()
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
        outs = _Outputs(n.name, out_cols, valid_out)

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

        # roofline attribution (util/coststats.py): batched device-kernel
        # calls join their analytical cost descriptor with measured
        # seconds
        track_cost = _cs.enabled() and batched_call \
            and n.effective_device() == DeviceType.TPU
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
                            outs.nulls(compute[dead])
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
                            new_sig = sig not in ki._shape_sigs
                            if new_sig:
                                ki._shape_sigs.add(sig)
                                _M_OP_SHAPES.labels(
                                    op=n.name,
                                    device=ki.dev_label).inc()
                                _tracing.add_event(
                                    "op.new_shape", op=n.name,
                                    device=ki.dev_label)
                            if new_sig and track_cost:
                                # first call of a fresh signature: a
                                # library build inside lands in the
                                # compile ledger under this (op, device,
                                # bucket); not measured, so a build
                                # never reads as inefficiency
                                with ki._call_lock, _cs.observe_compiles(
                                        n.name, ki.dev_label,
                                        len(exec_sel), repr(sig[1:])):
                                    res = ki.kernel.execute(*args)
                            elif track_cost and self._timer.due(
                                    (n.id, len(exec_sel))):
                                tok = self._timer.start(
                                    ki.device if ki.staged else None)
                                with ki._call_lock:
                                    res = ki.kernel.execute(*args)
                                self._timer.stop(tok, self._op_call_done(
                                    n.name, ki, len(exec_sel), len(live),
                                    args))
                            else:
                                with ki._call_lock:
                                    res = ki.kernel.execute(*args)
                            if pad:
                                res = _strip_pad(res, len(live),
                                                 len(out_cols))
                            outs.result(compute[live], res)
                        else:
                            args = call_args_for(live)
                            row_args = []
                            for a in args:
                                e = a[0]
                                if has_stencil and is_array_data(a):
                                    e = list(a[0])
                                row_args.append(e)
                            with ki._call_lock:
                                res = ki.kernel.execute(*row_args)
                            outs.result(compute[live],
                                        _single(res, n, out_cols))
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
            if _ms.is_oom(e):
                # dispatch-site forensics: the report names the ledger
                # entries (and their tasks) holding device memory when
                # this op's allocation failed
                _ms.note_oom(e, site="dispatch",
                             detail=f"op {n.name} on {ki.dev_label}")
            raise
        _M_OP_ROWS.labels(op=n.name).inc(len(compute))
        _M_OP_SECONDS.labels(op=n.name).inc(time.time() - t0)

        return outs.assemble()


    # -- fused chains ---------------------------------------------------

    def _run_fused(self, n: O.OpNode, jr: A.JobRows, plan: A.TaskPlan,
                   store) -> Dict[str, ColumnBatch]:
        """Dispatch one fused chain at its tail node `n`: gather the
        composed stencil window from the HEAD member's input column, run
        the chain through the chain's bucket ladder, and emit only the
        tail's outputs — member intermediates never materialize.
        Chain-level row semantics reproduce the staged path exactly:
        REPEAT_EDGE padding at every member level (compose_positions),
        null propagation over the composed window (a tail row is null
        iff ANY transitively-read input row is null), bucketed
        tail-chunk padding, nulls-last assembly."""
        chain = self.chains[n.id]
        fki = self.fused[n.id]
        ts = plan.streams[n.id]
        fki.ensure_warm()
        fki.bind_stream(plan.job_idx, plan.slice_group)

        head = chain.head
        in_col = head.input_columns()[0]
        in_b = store[(in_col.op.id, in_col.column)]
        g = plan.slice_group if self.info.slice_level[n.id] > 0 else 0
        max_in = jr.rows[in_col.op.id][g]

        # one chain-wide batch cap (see FusedKernelInstance.cap_for)
        wp = int(getattr(jr, "work_packet_size", 0) or 0)
        batch = fki.cap_for(wp)
        ladder = bucket_ladder(batch)

        # device staging: ONE host->device move for the head column —
        # the only transfer the whole chain pays on the input side
        if self.stage and isinstance(in_b.data, np.ndarray) \
                and in_b.data.dtype != object:
            in_b = in_b.to_device(fki.device)
        if in_b.convert is not None:
            in_b = in_b.converted()
        store[(in_col.op.id, in_col.column)] = in_b

        compute = np.asarray(ts.compute_rows, np.int64)
        out_cols = [c for c, _ in n.spec.output_columns]
        valid_out = np.asarray(ts.valid_output_rows, np.int64)

        # composed window positions per tail compute row (REPEAT_EDGE
        # at every member level = the staged transitive dilation)
        width = fki.width
        win_rows = fki.compose_positions(compute, max_in).reshape(
            len(compute), width)
        col_pos = in_b.positions(win_rows.reshape(-1)).reshape(
            win_rows.shape)

        # null propagation across the whole chain in one step
        null_in = np.zeros(len(compute), bool)
        if in_b.nulls is not None:
            null_in |= in_b.nulls[col_pos].any(axis=1)
        mask_nulls = in_b.nulls is None or is_array_data(in_b.data)

        outs = _Outputs(fki.chain_id, out_cols, valid_out)

        def call_data(sel: np.ndarray):
            """The head-input gather for compute positions `sel`: a
            (k * width, ...) batch in composed-window order (the chain
            re-folds the window axes member by member)."""
            p = col_pos[sel].reshape(-1)
            if is_array_data(in_b.data):
                return _index(in_b.data, p)
            # object column: stack per-row host data into one array
            return np.stack([np.asarray(in_b.data[int(j)]) for j in p])

        track_cost = _cs.enabled()
        t0 = time.time()
        try:
            with self.profiler.span("evaluate:" + fki.chain_id,
                                    rows=len(compute)):
                i = 0
                while i < len(compute):
                    j = min(i + batch, len(compute))
                    sel = np.arange(i, j)
                    dead = sel[null_in[sel]]
                    if len(dead):
                        outs.nulls(compute[dead])
                    if mask_nulls and len(dead) < len(sel):
                        live = sel
                    else:
                        live = sel[~null_in[sel]]
                    if not len(live):
                        i = j
                        continue
                    exec_sel = live
                    pad = bucket_for(len(live), ladder) - len(live)
                    if pad:
                        exec_sel = np.concatenate(
                            [live, np.repeat(live[-1:], pad)])
                        _M_OP_PAD_ROWS.labels(
                            op=fki.chain_id,
                            device=fki.dev_label).inc(pad)
                    arr = call_data(exec_sel)
                    # the stream args are part of the signature: a
                    # rebind that changes them is another graph
                    sig = (fki.dev_label, tuple(arr.shape), str(arr.dtype),
                           fki.program_key)
                    new_sig = sig not in fki._shape_sigs
                    if new_sig:
                        fki._shape_sigs.add(sig)
                        _M_OP_SHAPES.labels(
                            op=fki.chain_id,
                            device=fki.dev_label).inc()
                        _tracing.add_event("op.new_shape",
                                           op=fki.chain_id,
                                           device=fki.dev_label)
                    if new_sig and track_cost:
                        # fresh signature: ONE ledger entry for the whole
                        # chain (its graph capture), members recorded
                        with fki._call_lock, _cs.observe_compiles(
                                fki.chain_id, fki.dev_label,
                                len(exec_sel), repr(sig[1:3]),
                                members=fki.member_names):
                            res = fki.execute(arr)
                    elif track_cost and self._timer.due(
                            (n.id, len(exec_sel))):
                        tok = self._timer.start(
                            fki.device if fki.staged else None)
                        with fki._call_lock:
                            res = fki.execute(arr)
                        self._timer.stop(tok, self._chain_call_done(
                            fki, len(exec_sel), len(live), arr))
                    else:
                        with fki._call_lock:
                            res = fki.execute(arr)
                    if pad:
                        res = _strip_pad(res, len(live), len(out_cols))
                    outs.result(compute[live], res)
                    i = j
        except BaseException as e:
            if _ms.is_oom(e):
                _ms.note_oom(e, site="dispatch",
                             detail=f"chain {fki.chain_id} on "
                                    f"{fki.dev_label}")
            raise
        _M_OP_ROWS.labels(op=fki.chain_id).inc(len(compute))
        _M_OP_SECONDS.labels(op=fki.chain_id).inc(time.time() - t0)

        return outs.assemble()

    def _chain_call_done(self, fki: FusedKernelInstance, bucket: int,
                         rows: int, arr):
        """The CallTimer callback of one measured fused call: the chain
        row of the roofline ledger and the chain gauges."""
        desc, saved = fki.cost_for(arr.shape, arr.dtype)

        def done(seconds: float) -> None:
            cls = _cs.record_op_call(fki.chain_id, fki.dev_label, bucket,
                                     rows, seconds, desc)
            if cls is not None:
                _fusion.chain_metrics_for(fki.chain_id, fki.dev_label,
                                          bucket, cls, saved)
        return done


class _Outputs:
    """One op run's results by output column: kernel results and
    null-propagated rows, kept to the run's valid output rows (warm-up
    rows dropped) and assembled in row order."""

    def __init__(self, name: str, out_cols: List[str],
                 valid_out: np.ndarray):
        self.name = name
        self.out_cols = out_cols
        self.valid_out = valid_out
        self.parts: Dict[str, List[ColumnBatch]] = {c: [] for c in out_cols}
        self.null_rows: List[int] = []

    def _emit(self, col: str, rows: np.ndarray, data, per_row: bool):
        keep = np.isin(rows, self.valid_out)
        if not keep.any():
            return
        if per_row:
            kept = [d for d, k in zip(data, keep) if k]
            self.parts[col].append(ColumnBatch.from_elements(rows[keep],
                                                             kept))
        elif keep.all():
            self.parts[col].append(ColumnBatch(rows, data))
        else:
            idx = np.flatnonzero(keep)
            self.parts[col].append(ColumnBatch(rows[keep], _index(data, idx)))

    def result(self, rows: np.ndarray, res) -> None:
        """Dispatch one call's result to output columns.  Multi-output
        batch kernels may return either a tuple of per-column batches or
        a list of per-row tuples (the classic protocol)."""
        n_out = len(self.out_cols)
        if n_out == 1:
            cols_res = (res,)
        elif isinstance(res, tuple) and len(res) == n_out:
            cols_res = res
        elif (isinstance(res, list) and len(res) == len(rows)
              and all(isinstance(r, tuple) and len(r) == n_out
                      for r in res)):
            cols_res = tuple(list(col) for col in zip(*res))
        else:
            raise JobException(
                f"{self.name}: expected {n_out}-tuple output")
        for col, r in zip(self.out_cols, cols_res):
            if is_array_data(r) and len(r) == len(rows):
                self._emit(col, rows, r, per_row=False)
            else:
                if r is None or len(r) != len(rows):
                    raise JobException(
                        f"{self.name}: batch kernel returned "
                        f"{0 if r is None else len(r)} results "
                        f"for {len(rows)} inputs")
                self._emit(col, rows, list(r), per_row=True)

    def nulls(self, rows: np.ndarray) -> None:
        keep = np.isin(rows, self.valid_out)
        if keep.any():
            self.null_rows.extend(rows[keep].tolist())

    def assemble(self) -> Dict[str, ColumnBatch]:
        """Output columns in row order.  Null-propagated rows (rare)
        interleave with kernel results, so columns holding them take
        per-element assembly, nulls LAST so they win: bucketed dispatch
        runs dead rows through the kernel (full-chunk shape) and their
        outputs must be discarded."""
        valid_set = set(self.valid_out.tolist())
        null_set = set(self.null_rows)
        outputs: Dict[str, ColumnBatch] = {}
        for col in self.out_cols:
            parts = self.parts[col]
            if not parts and not null_set:
                outputs[col] = ColumnBatch(np.zeros(0, np.int64), [])
                continue
            if null_set:
                by_row: Dict[int, Elem] = {}
                for p in parts:
                    for r, e in zip(p.rows.tolist(), p.elements()):
                        by_row[r] = e
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
                    f"{self.name}: missing output rows {missing[:5]}...")
        return outputs


def _single(res, n, out_cols):
    """Wrap a batch=1 result to per-row list form for _Outputs.result."""
    if len(out_cols) == 1:
        return [res]
    if not isinstance(res, tuple) or len(res) != len(out_cols):
        raise JobException(
            f"{n.name}: expected {len(out_cols)}-tuple output")
    return tuple([v] for v in res)
