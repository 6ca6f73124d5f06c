"""Common types shared across the framework.

Capability parity: reference scannerpy/common.py (DeviceType:36, CacheMode:72,
PerfParams:78) — re-designed for a host+TPU execution model rather than
CPU/GPU kernel placement.  This is the PyTorch/CUDA port's copy; the
accelerator is a CUDA card.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


class ScannerException(Exception):
    """Base exception for all framework errors."""


class GraphException(ScannerException):
    """Raised when a computation graph is malformed."""


class JobException(ScannerException):
    """Raised when a bulk job fails."""


class StorageException(ScannerException):
    """Raised on storage backend errors."""


class DeviceOutOfMemory(ScannerException):
    """Device memory exhaustion (RESOURCE_EXHAUSTED) observed at an
    engine staging/dispatch site — classified transient so the master
    requeues the task strike-free after its staged buffers are freed
    (util/memstats.py OOM forensics; the `memory.pressure` fault site
    raises this to force the path deterministically on CPU)."""


class DeviceType(enum.Enum):
    """Where a kernel runs.

    The reference dispatches CPU vs GPU (common.h:53-82); here the split is
    host (numpy, C++ helpers) vs the accelerator (torch tensors on the
    client's device — a CUDA card, or the CPU when the caller asks for
    it).  Device ops register under the name TPU, so graphs written for
    the JAX package register unchanged; DeviceType.GPU is an alias.
    """

    CPU = "cpu"
    TPU = "tpu"
    GPU = "tpu"  # alias: accelerator

    @property
    def is_accelerator(self) -> bool:
        return self is not DeviceType.CPU


class FrameType:
    """Marker type for video-frame columns in kernel type annotations."""


class BlobType:
    """Marker type for raw-bytes columns."""


class CacheMode(enum.Enum):
    """What to do when a job's output stream already exists.

    Mirrors reference CacheMode (common.py:72): Error refuses, Ignore skips
    already-committed outputs (job-level resume), Overwrite recomputes.
    """

    Error = 0
    Ignore = 1
    Overwrite = 2


class BoundaryCondition(enum.Enum):
    """Stencil boundary handling. Only REPEAT_EDGE is supported, matching the
    reference (assert at evaluate_worker.cpp:413)."""

    REPEAT_EDGE = 0


@dataclass
class PerfParams:
    """Performance knobs for a bulk job.

    io_packet_size: rows per storage/decode unit of work (task granularity is
      a multiple of this); work_packet_size: rows per compute batch pushed to
      a kernel group (the XLA batch dimension).
    Mirrors reference PerfParams (common.py:78-160) with TPU-centric defaults.
    """

    work_packet_size: int = 16
    io_packet_size: int = 64
    # Evaluator pipeline instances per node.  None resolves at job launch
    # (engine/evaluate.py default_pipeline_instances): one device-affine
    # instance per local chip on multi-device accelerator hosts —
    # instance i owns chip i, stages its tasks' inputs there and runs
    # the shared jitted kernels on it — and 1 elsewhere.  An explicit
    # value here (or on the Client/Worker constructor) always wins.
    pipeline_instances_per_node: Optional[int] = None
    load_sparsity_threshold: int = 8
    queue_size_per_pipeline: int = 4
    task_timeout: float = 0.0  # seconds; 0 = no timeout
    checkpoint_frequency: int = 10
    # profiling detail recorded during the job: 0 = coarse stage spans
    # only, 1 = per-task detail (default), 2 = verbose (reference
    # rpc.proto:270-275 profiler_level)
    profiler_level: int = 1
    # Opt-in task affinity for unbounded-state ops: consecutive tasks of
    # a job carry kernel state forward instead of recomputing rows
    # 0..end per task — O(n) total work instead of O(n^2/io_packet) on
    # long un-sliced streams (the reference pins a job's packets to one
    # worker, worker.cpp:373-415 save_coordinator).  Evaluation of such
    # a job serializes onto one pipeline instance (and, in a cluster,
    # one worker per job); any break in the chain — reordering, a
    # failed task, worker death — falls back to the self-contained
    # recompute, so results never depend on the affinity holding.
    stateful_task_affinity: bool = False
    # Work-packet streaming: a task's io packet never materializes
    # whole — the loader decodes work-packet-sized chunks through an
    # incremental decoder session and the evaluator consumes them as
    # they arrive, carrying kernel state across chunk boundaries.
    # Bounds peak memory to a few work packets per task (the 4K case)
    # and overlaps decode/h2d/compute inside a task (reference element
    # cache + feeder threads, evaluate_worker.h:207-218).
    stream_work_packets: bool = True
    # Gang-scheduled multi-host execution (engine/gang.py,
    # docs/robustness.md §Gang scheduling): >0 asks the master to
    # co-schedule each task onto a GANG of up to this many live
    # workers instead of handing it to one puller — the members
    # rendezvous into one torch.distributed group (member 0 is the
    # coordinator), each evaluates the task REPLICATED (deterministic
    # redundancy, not a sharded speedup — this knob buys failure
    # semantics, N× the compute), stages its per-host shard of the
    # result digest via host_local_array and agrees through one
    # cross-host collective reduction, and commits through member 0
    # alone (exactly-once sink).  Every gang RPC is fenced by
    # (gang_id, gang_epoch): any member loss aborts the gang, bumps
    # the epoch and re-forms on the remaining capacity, strike-free.
    # 0 (default) = ordinary independent task pulls; local
    # (in-process) runs treat any value as a single-host gang and
    # execute normally.
    gang_hosts: int = 0
    # Mesh-partitioned gang evaluation (default): each member loads,
    # decodes and evaluates ONLY its contiguous row shard of every
    # task (shard_range over the gang mesh), stencil boundary rows
    # move between neighbors over the interconnect (parallel/halo.py)
    # instead of widening each member's decode, and member 0 — still
    # the single writer — assembles the per-member output shards over
    # one all-gather and commits after the digest collective agrees:
    # per-gang throughput is ~N× the replicated path's.  False = the
    # pre-sharding replicated evaluation (every member computes all
    # rows; N× redundancy, kept as the A/B + fallback mode).  A
    # re-formed smaller gang just recomputes shard_range at the new
    # member count.  Effective only with gang_hosts > 0; the master's
    # [gang] sharded config must also be on.
    gang_sharded: bool = True

    # reference-compat kwargs that are meaningless on TPU and accepted but
    # ignored (XLA owns device/host memory pooling; there is no CUDA pool
    # to size — reference common.py cpu_pool/gpu_pool)
    _IGNORED_KWARGS = ("cpu_pool", "gpu_pool", "pinned_cpu_pool")

    @classmethod
    def _strip_ignored(cls, kw: dict) -> dict:
        for k in cls._IGNORED_KWARGS:
            kw.pop(k, None)
        return kw

    @classmethod
    def manual(cls, work_packet_size: int, io_packet_size: int, **kw) -> "PerfParams":
        if io_packet_size % work_packet_size != 0:
            raise ScannerException(
                f"io_packet_size ({io_packet_size}) must be a multiple of "
                f"work_packet_size ({work_packet_size})")
        return cls(work_packet_size=work_packet_size,
                   io_packet_size=io_packet_size, **cls._strip_ignored(kw))

    @classmethod
    def estimate(cls, **kw) -> "PerfParams":
        """Auto-tuned variant; heuristics are applied at job-launch time when
        stream geometry is known (engine/executor.py)."""
        p = cls(**cls._strip_ignored(kw))
        p._estimate = True  # type: ignore[attr-defined]
        return p


class NullElement:
    """Placeholder for a null row produced by RepeatNull spacing or missed
    dependencies (reference storage.py:8)."""

    _instance: Optional["NullElement"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:
        return "NullElement"

    def __reduce__(self):
        return (NullElement, ())


class SliceList(list):
    """Marks a per-job argument list as being per-slice-group rather than a
    plain value (reference op.py SliceList)."""
