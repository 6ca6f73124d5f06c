"""DAG analysis: validation, row-domain sizing, task generation, and
backward row-requirement derivation.

Capability parity: reference scanner/engine/dag_analysis.{h,cpp} —
validate_jobs_and_ops (:43), populate_analysis_info (:898),
perform_liveness_analysis (:1145), derive_stencil_requirements (:1328-1746).

The computation graph is a DAG of OpNodes.  For each job (input-stream
binding) the analysis:
  1. validates the graph (slice-level agreement, IO placement, equal-length
     zips),
  2. sizes every op's row domain per slice group (forward pass),
  3. chunks the output domain into tasks aligned to slice-group boundaries,
  4. for one task, walks the DAG backwards deriving, per op, exactly which
     input rows are needed (through samplers, stencils, warmup, slices) —
     producing the TaskStreams the evaluate stage executes and the minimal
     row set the source must load/decode.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..common import GraphException, SliceList
from . import ops as O
from . import samplers as S


# ---------------------------------------------------------------------------
# Graph structure analysis (job-independent)
# ---------------------------------------------------------------------------

@dataclass
class GraphInfo:
    ops: List[O.OpNode]                       # topological order
    op_index: Dict[int, int]                  # node id -> position
    consumers: Dict[int, List[int]]           # node id -> consumer node ids
    slice_level: Dict[int, int]               # node id -> slice depth
    sources: List[O.OpNode]
    sinks: List[O.OpNode]
    num_jobs: int

    def op_at(self, node_id: int) -> O.OpNode:
        return self.ops[self.op_index[node_id]]


def analyze(outputs: Sequence[O.OpNode]) -> GraphInfo:
    """Validate and linearize the graph reachable from the given sinks."""
    sinks = list(outputs)
    for s in sinks:
        if s.name != O.OUTPUT_OP:
            raise GraphException("run() targets must be io.Output ops")

    # toposort (reference client.py:448 _toposort)
    order: List[O.OpNode] = []
    state: Dict[int, int] = {}

    def visit(n: O.OpNode):
        st = state.get(n.id, 0)
        if st == 1:
            raise GraphException("graph contains a cycle")
        if st == 2:
            return
        state[n.id] = 1
        for c in n.input_columns():
            visit(c.op)
        state[n.id] = 2
        order.append(n)

    for s in sinks:
        visit(s)

    consumers: Dict[int, List[int]] = {n.id: [] for n in order}
    for n in order:
        for c in n.input_columns():
            consumers[c.op.id].append(n.id)

    sources = [n for n in order if n.name == O.INPUT_OP]
    if not sources:
        raise GraphException("graph has no io.Input source")
    # IO only at graph edges (reference dag_analysis remap invariants)
    for n in order:
        if n.name == O.OUTPUT_OP and consumers[n.id]:
            raise GraphException("io.Output cannot feed other ops")
        if n.name == O.INPUT_OP and n.input_columns():
            raise GraphException("io.Input takes no graph inputs")

    # only one slice/unslice pair per pipeline (reference
    # evaluate_worker.cpp:844-847 "we guarantee only one slice per pipeline")
    n_slices = sum(1 for n in order if n.name == O.SLICE_OP)
    n_unslices = sum(1 for n in order if n.name == O.UNSLICE_OP)
    if n_slices > 1 or n_unslices > 1:
        raise GraphException("only one Slice/Unslice pair per graph")

    # slice levels (reference: single slice level, no nesting,
    # dag_analysis.cpp:70-154)
    level: Dict[int, int] = {}
    for n in order:
        in_levels = {level[c.op.id] for c in n.input_columns()}
        if len(in_levels) > 1:
            raise GraphException(
                f"op {n.name}: inputs at differing slice levels {in_levels}")
        base = in_levels.pop() if in_levels else 0
        if n.name == O.SLICE_OP:
            if base != 0:
                raise GraphException("nested slices are not supported")
            level[n.id] = 1
        elif n.name == O.UNSLICE_OP:
            if base != 1:
                raise GraphException("unslice without matching slice")
            level[n.id] = 0
        else:
            level[n.id] = base
    for s in sinks:
        if level[s.id] != 0:
            raise GraphException(
                "sliced streams must be unsliced before io.Output")
    # unslice outputs may only feed sinks (reference evaluate_worker
    # guarantee, dag_analysis.cpp:151-153)
    for n in order:
        if n.name == O.UNSLICE_OP:
            for cid in consumers[n.id]:
                cons = next(x for x in order if x.id == cid)
                if cons.name not in (O.OUTPUT_OP,):
                    raise GraphException(
                        "unslice output may only feed io.Output")

    # number of jobs: every per-stream binding must agree
    njobs: Optional[int] = None

    def check_n(n_streams: int, what: str):
        nonlocal njobs
        if njobs is None:
            njobs = n_streams
        elif njobs != n_streams:
            raise GraphException(
                f"{what} binds {n_streams} streams but job count is {njobs}")

    for n in order:
        if n.name == O.INPUT_OP:
            check_n(len(n.extra["streams"]), "io.Input")
        elif n.name == O.OUTPUT_OP:
            check_n(len(n.extra["streams"]), "io.Output")
        if n.extra.get("args_per_stream") is not None:
            check_n(len(n.extra["args_per_stream"]), f"{n.name} args")
        for k, v in n.job_args.items():
            check_n(len(v), f"{n.name}.{k}")
    assert njobs is not None

    return GraphInfo(ops=order,
                     op_index={n.id: i for i, n in enumerate(order)},
                     consumers=consumers, slice_level=level,
                     sources=sources, sinks=sinks, num_jobs=njobs)


# ---------------------------------------------------------------------------
# Per-job row sizing (forward pass)
# ---------------------------------------------------------------------------

@dataclass
class JobRows:
    job_idx: int
    # node id -> rows per slice group (level 0 => single entry)
    rows: Dict[int, List[int]]
    # node id -> sampler per group (Sample/Space ops)
    samplers: Dict[int, List[S.DomainSampler]]
    # node id -> partitioner (Slice ops)
    partitioners: Dict[int, S.Partitioner]
    num_groups: int  # 1 if no slicing
    # output row count (all sinks validated equal)
    output_rows: int
    # output-domain slice-group boundaries (cumulative ends); [output_rows]
    # when no slicing
    group_ends: List[int]
    # rows per compute batch pushed to a batch-capable kernel (the XLA
    # batch dimension) — resolved from PerfParams.work_packet_size at job
    # preparation (reference io/work packet split, master.cpp:1421)
    work_packet_size: int = 16


def _sampler_args_for(node: O.OpNode, job_idx: int):
    args = node.extra.get("args_per_stream")
    if args is None:
        # argless samplers (All) apply identically to every stream
        return {}
    return args[job_idx]


def job_rows(info: GraphInfo, job_idx: int,
             source_rows: Dict[int, int]) -> JobRows:
    """Forward-size every op's row domain for one job.

    source_rows: node id of each Input op -> stream length.
    """
    rows: Dict[int, List[int]] = {}
    samplers: Dict[int, List[S.DomainSampler]] = {}
    partitioners: Dict[int, S.Partitioner] = {}
    num_groups = 1

    for n in info.ops:
        if n.name == O.INPUT_OP:
            rows[n.id] = [source_rows[n.id]]
        elif n.name in (O.SAMPLE_OP, O.SPACE_OP):
            inp = n.input_columns()[0].op
            kind = n.extra["sampler_kind"]
            args = _sampler_args_for(n, job_idx)
            per_group: List[S.DomainSampler] = []
            in_rows = rows[inp.id]
            if isinstance(args, SliceList):
                if info.slice_level[n.id] == 0:
                    raise GraphException(
                        f"{n.name}: SliceList args outside a slice")
                if len(args) != len(in_rows):
                    raise GraphException(
                        f"{n.name}: SliceList has {len(args)} entries for "
                        f"{len(in_rows)} slice groups")
                for a in args:
                    per_group.append(S.make_sampler(kind, a))
            else:
                per_group = [S.make_sampler(kind, args)] * len(in_rows)
            samplers[n.id] = per_group
            rows[n.id] = [per_group[g].num_downstream(in_rows[g])
                          for g in range(len(in_rows))]
        elif n.name == O.SLICE_OP:
            inp = n.input_columns()[0].op
            kind = n.extra["partitioner_kind"]
            args = _sampler_args_for(n, job_idx)
            part = S.make_partitioner(kind, rows[inp.id][0], args)
            partitioners[n.id] = part
            rows[n.id] = part.rows_per_group()
            num_groups = part.total_groups()
        elif n.name == O.UNSLICE_OP:
            inp = n.input_columns()[0].op
            rows[n.id] = [int(sum(rows[inp.id]))]
        else:
            in_cols = n.input_columns()
            first = rows[in_cols[0].op.id]
            for c in in_cols[1:]:
                if rows[c.op.id] != first:
                    raise GraphException(
                        f"op {n.name}: input row domains differ "
                        f"({rows[c.op.id]} vs {first}); all zipped inputs "
                        f"must have equal lengths")
            rows[n.id] = list(first)

    out_counts = {rows[s.input_columns()[0].op.id][0] for s in info.sinks}
    if len(out_counts) != 1:
        raise GraphException(
            f"all outputs must have the same number of rows, got "
            f"{sorted(out_counts)}")
    output_rows = out_counts.pop()

    # output-domain group boundaries: from the unslice feeding the sink
    # chain if any slicing happened
    group_ends = [output_rows]
    for n in info.ops:
        if n.name == O.UNSLICE_OP:
            inp = n.input_columns()[0].op
            group_ends = list(np.cumsum(rows[inp.id]).astype(int))
            break

    return JobRows(job_idx=job_idx, rows=rows, samplers=samplers,
                   partitioners=partitioners, num_groups=num_groups,
                   output_rows=output_rows, group_ends=group_ends)


# ---------------------------------------------------------------------------
# Task generation (reference master.cpp:1558-1607)
# ---------------------------------------------------------------------------

def generate_tasks(jr: JobRows, io_packet_size: int) -> List[Tuple[int, int]]:
    """Chunk the output domain into [start, end) tasks of at most
    io_packet_size rows, never crossing a slice-group boundary."""
    if io_packet_size <= 0:
        raise GraphException(
            f"io_packet_size must be > 0, got {io_packet_size}")
    tasks: List[Tuple[int, int]] = []
    start = 0
    for end in jr.group_ends:
        s = start
        while s < end:
            e = min(s + io_packet_size, end)
            tasks.append((s, e))
            s = e
        start = end
    return tasks


# ---------------------------------------------------------------------------
# Backward derivation (reference derive_stencil_requirements,
# dag_analysis.cpp:1328-1746)
# ---------------------------------------------------------------------------

@dataclass
class TaskStream:
    """Per-op row bookkeeping for one task (reference runtime.h:69)."""
    node_id: int
    slice_group: int
    valid_input_rows: np.ndarray    # rows of the op's input domain it receives
    compute_rows: np.ndarray        # rows it must execute (incl. warmup)
    valid_output_rows: np.ndarray   # rows it must hand downstream


@dataclass
class TaskPlan:
    job_idx: int
    task_idx: int
    output_range: Tuple[int, int]
    streams: Dict[int, TaskStream]          # node id -> stream
    # Input node id -> rows of the stored stream to load/decode
    source_rows: Dict[int, np.ndarray]
    slice_group: int
    # (unbounded-state node id, slice group) -> last compute row this
    # plan advances the kernel through; the NEXT task of an affinity
    # chain may start its recompute after this watermark
    carry_watermarks: Dict[Tuple[int, int], int] = field(
        default_factory=dict)


def derive_task_streams(info: GraphInfo, jr: JobRows,
                        output_range: Tuple[int, int],
                        job_idx: int = 0, task_idx: int = 0,
                        carry: Optional[Dict[Tuple[int, int], int]] = None
                        ) -> TaskPlan:
    out_rows = np.arange(output_range[0], output_range[1], dtype=np.int64)

    required_out: Dict[int, set] = {n.id: set() for n in info.ops}
    for s in info.sinks:
        required_out[s.id].update(out_rows.tolist())

    streams: Dict[int, TaskStream] = {}
    source_rows: Dict[int, np.ndarray] = {}
    watermarks: Dict[Tuple[int, int], int] = {}
    slice_group = 0

    for n in reversed(info.ops):
        downstream = np.asarray(sorted(required_out[n.id]), np.int64)
        compute = None

        if n.name == O.INPUT_OP:
            new_rows = downstream
            source_rows[n.id] = new_rows
        elif n.name in (O.SAMPLE_OP, O.SPACE_OP):
            g = slice_group if info.slice_level[n.id] > 0 else 0
            new_rows = jr.samplers[n.id][g].upstream_rows(downstream)
        elif n.name == O.SLICE_OP:
            # rows are group-local below the slice; remap into the global
            # input domain (task never crosses groups)
            group = jr.partitioners[n.id].group_at(slice_group)
            new_rows = group[downstream]
        elif n.name == O.UNSLICE_OP:
            # locate the single group containing this task's rows
            inp = n.input_columns()[0].op
            counts = jr.rows[inp.id]
            offsets = np.concatenate([[0], np.cumsum(counts)])
            lo, hi = int(downstream[0]), int(downstream[-1])
            g = int(np.searchsorted(offsets, lo, side="right")) - 1
            if g < 0 or hi >= offsets[g + 1]:
                raise GraphException(
                    f"task rows {lo}..{hi} cross slice-group boundaries "
                    f"{list(offsets)}")
            slice_group = g
            new_rows = downstream - offsets[g]
        elif n.name == O.OUTPUT_OP:
            new_rows = downstream
        else:
            # regular op: state warmup, then stencil dilation, then clamp
            cur = set(downstream.tolist())
            if n.spec is not None and n.spec.unbounded_state:
                # Unbounded state means EVERY task recomputes rows 0..end
                # so tasks stay self-contained and reassignable (the
                # reference instead pins a task's packets to one worker,
                # save_coordinator worker.cpp:373-415).  Total work is
                # O(stream_len^2 / io_packet) — UNLESS the caller opts
                # into stateful task affinity (PerfParams
                # .stateful_task_affinity), where `carry` names the row
                # each kernel's state already advanced through in this
                # (job, slice group): the task then recomputes only the
                # rows past the watermark, O(n) total.  The evaluator
                # verifies the premise at run time (KernelInstance
                # watermark) and falls back to the self-contained plan on
                # any mismatch, so correctness never rests on the carry.
                # Long un-sliced streams WITHOUT affinity should Slice()
                # (per-group state reset bounds the recompute span) or
                # declare bounded_state.
                g = slice_group if info.slice_level[n.id] > 0 else 0
                lo = 0
                if carry is not None:
                    mark = carry.get((n.id, g))
                    # carry only when every needed output is past the
                    # watermark — an already-consumed output row cannot
                    # be re-emitted by a stateful kernel
                    if mark is not None and len(downstream) \
                            and int(downstream[0]) > mark:
                        lo = mark + 1
                cur = set(range(lo, int(downstream[-1]) + 1)) \
                    if len(downstream) else set()
                if len(downstream):
                    watermarks[(n.id, g)] = int(downstream[-1])
            elif ((n.spec is not None and n.spec.bounded_state is not None)
                  or n.warmup is not None):
                warmup = n.warmup if n.warmup is not None \
                    else n.spec.bounded_state
                for r in downstream.tolist():
                    for i in range(warmup + 1):
                        if r - i >= 0:
                            cur.add(r - i)
            compute = np.asarray(sorted(cur), np.int64)
            stencil = n.effective_stencil()
            sten = set()
            for r in cur:
                for s_off in stencil:
                    sten.add(r + s_off)
            g = slice_group if info.slice_level[n.id] > 0 else 0
            in_op = n.input_columns()[0].op
            max_rows = jr.rows[in_op.id][g]
            new_rows = np.asarray(
                sorted(r for r in sten if 0 <= r < max_rows), np.int64)

        if not n.name == O.INPUT_OP:
            for c in n.input_columns():
                required_out[c.op.id].update(new_rows.tolist())

        if compute is None:
            compute = new_rows

        streams[n.id] = TaskStream(
            node_id=n.id, slice_group=slice_group,
            valid_input_rows=new_rows, compute_rows=compute,
            valid_output_rows=downstream)

    # nodes visited before the Unslice (the sinks) were stamped with the
    # initial slice_group; a task is always within one group, so backfill
    for ts in streams.values():
        ts.slice_group = slice_group

    # (sliced nodes sit upstream of their Unslice, so the reversed walk
    # fixes slice_group before visiting them — watermark keys are final)
    return TaskPlan(job_idx=job_idx, task_idx=task_idx,
                    output_range=output_range, streams=streams,
                    source_rows=source_rows, slice_group=slice_group,
                    carry_watermarks=watermarks)
