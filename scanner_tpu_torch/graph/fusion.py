"""Whole-pipeline fusion planning: chains of fusable device ops.

The counterpart of the JAX package's graph/fusion.py; the planner is the
same line for line.  The evaluate stage is a per-op pipeline: every
device op is its own call, so op boundaries are dispatch points, and on
the card each plain-torch op (Resize, Blur) is a string of small kernel
launches the host issues one by one.  This module plans which runs of
ops execute as one unit:

  * ``plan_chains`` walks a ``GraphInfo`` and groups maximal runs of
    fusable device ops.  A node is fusable when it is a stateless,
    non-variadic, batched (batch > 1) single-input/single-output device
    kernel whose class declares a ``cost()`` descriptor (the hook both
    feeds the fuse decision and marks the execute body as composable —
    see ``Kernel.execute_traced``).  Host ops, stateful kernels, and
    explicit ``fuse=False`` node overrides break chains.  A chain
    extends only while its tail has exactly ONE consumer (an
    intermediate read by anything else must materialize, so it becomes
    the chain's tail instead).
  * The fuse decision is cost-driven: when the roofline ledger
    (util/coststats.py ``op_efficiency``) already classified EVERY
    member of a candidate chain as compute-bound, fusion saves no
    device-memory traffic and the chain stays staged; any memory-bound
    (or not-yet-measured) member makes the chain worth fusing.
  * A windowed (stencil) op may only head a chain: its window composes
    into the chain's input gather, with REPEAT_EDGE clamping applied at
    every level exactly as the staged backward dilation
    (graph/analysis.py ``derive_task_streams``) applies it.

The execution half — ``FusedKernelInstance`` composing the member
``execute_traced`` bodies, captured as one CUDA graph per bucket on a
card — lives in engine/evaluate.py.

``SCANNER_TPU_FUSION=0`` is the kill switch / A/B lever (read at
import; ``set_enabled`` overrides it in-process).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from ..common import DeviceType
from ..util import coststats as _cs
from ..util import metrics as _mx
from ..util import tracing as _tracing
from ..util.log import get_logger
from . import ops as O

_log = get_logger("fusion")

_M_CHAINS = _mx.registry().gauge(
    "scanner_tpu_fusion_chains_planned",
    "Member count of each fused chain the planner formed (one labeled "
    "sample per chain id; 0 chains planned leaves the series empty).",
    labels=["chain"])
_M_CHAIN_FLOPS = _mx.registry().gauge(
    "scanner_tpu_fusion_chain_flops_per_s",
    "Achieved FLOP/s of a fused chain's measured calls (member cost() "
    "descriptors summed, joined with measured seconds), per chain id, "
    "device and bucket.",
    labels=["chain", "device", "bucket"])
_M_CHAIN_BW = _mx.registry().gauge(
    "scanner_tpu_fusion_chain_bytes_per_s",
    "Achieved device-memory bandwidth of a fused chain's measured calls "
    "— the chain reads its head input and writes its tail output — per "
    "chain id, device and bucket.",
    labels=["chain", "device", "bucket"])
_M_BYTES_SAVED = _mx.registry().counter(
    "scanner_tpu_fusion_intermediate_bytes_saved_total",
    "Intermediate traffic (member output writes + next-member input "
    "reads, from the member cost() descriptors) that fused dispatch "
    "avoided charging to separate op calls, per chain id and device.",
    labels=["chain", "device"])


# -- knobs ------------------------------------------------------------------

_ENABLED = _tracing._env_on("SCANNER_TPU_FUSION")


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    """Programmatic override (tests, A/B runs); the SCANNER_TPU_FUSION
    env var is read at import."""
    global _ENABLED
    _ENABLED = bool(on)


_MIN_CHAIN = 2


def fusion_min_chain() -> int:
    return _MIN_CHAIN


def set_min_chain(n: int) -> None:
    """Minimum member count for a chain to fuse (< 2 is meaningless — a
    singleton IS the staged path)."""
    global _MIN_CHAIN
    _MIN_CHAIN = max(2, int(n))


# -- the planner ------------------------------------------------------------

@dataclass
class FusionChain:
    """One maximal run of fusable ops, head -> tail in dataflow order.
    Only the tail's output materializes; the engine composes the member
    execute bodies into one fused call (FusedKernelInstance)."""

    members: List[O.OpNode]

    @property
    def head(self) -> O.OpNode:
        return self.members[0]

    @property
    def tail(self) -> O.OpNode:
        return self.members[-1]

    @property
    def chain_id(self) -> str:
        """The stable chain identity observability keys on: the member
        op names joined with '+' (e.g. "Resize+Blur+Histogram")."""
        return "+".join(m.name for m in self.members)

    @property
    def member_names(self) -> List[str]:
        return [m.name for m in self.members]

    def stencils(self) -> List[List[int]]:
        return [m.effective_stencil() for m in self.members]

    def windows(self) -> List[int]:
        """Per-member stencil-window length; 0 = the member takes no
        window axis (stencil [0]).  Note a 1-offset stencil like [-1]
        still carries a window axis of length 1."""
        return [len(s) if s != [0] else 0 for s in self.stencils()]

    def width(self) -> int:
        """Total read-window expansion of the composed chain stencil:
        one tail row reads `width` head-input positions."""
        w = 1
        for win in self.windows():
            w *= max(win, 1)
        return w


def fusable(node: O.OpNode) -> bool:
    """Chain eligibility for one node.  The ``cost()``-override
    requirement is load-bearing twice over: the planner needs the
    descriptor for the fuse decision and the chain-level roofline
    gauges, and declaring it marks the kernel's execute body as
    composable (``execute_traced``)."""
    if node.is_builtin or node.spec is None:
        return False
    if node.fuse is False:
        return False
    spec = node.spec
    if spec.is_stateful or spec.variadic:
        return False
    if node.warmup is not None:
        return False
    if node.effective_device() != DeviceType.TPU:
        return False
    if node.effective_batch() <= 1:
        return False
    if len(spec.input_columns) != 1 or len(spec.output_columns) != 1:
        return False
    fac = spec.kernel_factory
    if fac is None or getattr(fac, "cost", None) is O.Kernel.cost:
        return False
    return True


def _ledger_probe(node: O.OpNode) -> Optional[str]:
    """Roofline verdict for one op from the live ledger: "memory" when
    any measured (device, bucket) row of the op is memory-bound,
    "compute" when every one is compute-bound, None when the op was
    never measured."""
    bounds = {r["bound"] for r in _cs.op_efficiency() if r["op"] == node.name}
    if not bounds:
        return None
    if "memory" in bounds:
        return "memory"
    return "compute"


def plan_chains(info, min_chain: Optional[int] = None,
                probe: Optional[Callable[[O.OpNode], Optional[str]]]
                = None) -> List[FusionChain]:
    """Group maximal runs of fusable ops in `info` (a GraphInfo) into
    FusionChains.  `min_chain` defaults to `fusion_min_chain()`;
    `probe` defaults to the roofline-ledger verdict (tests inject their
    own)."""
    if min_chain is None:
        min_chain = fusion_min_chain()
    if probe is None:
        probe = _ledger_probe
    chains: List[FusionChain] = []
    used: set = set()
    for n in info.ops:
        if n.id in used or not fusable(n):
            continue
        # topo order reaches the head of every maximal run first: a
        # fusable producer with this node as its single consumer would
        # already have absorbed it into `used`
        members = [n]
        used.add(n.id)
        cur = n
        while True:
            cons = info.consumers.get(cur.id, [])
            if len(cons) != 1:
                break  # externally consumed (or a sink): cur is the tail
            nxt = info.op_at(cons[0])
            if nxt.id in used or not fusable(nxt):
                break
            # a windowed op may only HEAD a chain: as the head its
            # stencil composes into the chain's input gather (same rows
            # the staged path read), but mid-chain the window would make
            # the fused call recompute every upstream member once per
            # window element — the staged stencil cache computes each
            # intermediate row exactly once, so fusing across it loses.
            sten = nxt.effective_stencil()
            if sten != [0]:
                break
            members.append(nxt)
            used.add(nxt.id)
            cur = nxt
        if len(members) < max(2, int(min_chain)):
            continue
        # cost-driven no-fuse: when the ledger already judged EVERY
        # member compute-bound, fusing saves no memory traffic.  Any
        # memory-bound or unmeasured member keeps the chain.
        verdicts = [probe(m) for m in members]
        if all(v == "compute" for v in verdicts):
            _log.debug("chain %s stays staged: all members compute-bound",
                       "+".join(m.name for m in members))
            continue
        ch = FusionChain(members=members)
        chains.append(ch)
        _M_CHAINS.labels(chain=ch.chain_id).set(len(members))
    return chains


def chain_metrics_for(chain_id: str, device: str, bucket: int,
                      cls: Dict, saved_bytes: float) -> None:
    """Refresh the chain-level roofline gauges from one measured fused
    call's cumulative classification (coststats.classify shape)."""
    b = str(int(bucket))
    _M_CHAIN_FLOPS.labels(chain=chain_id, device=device, bucket=b).set(
        cls["flops_per_s"])
    _M_CHAIN_BW.labels(chain=chain_id, device=device, bucket=b).set(
        cls["bytes_per_s"])
    if saved_bytes > 0:
        _M_BYTES_SAVED.labels(chain=chain_id, device=device).inc(
            saved_bytes)
