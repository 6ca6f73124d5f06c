"""Bounded-interleaving explorer for the protocol model.

Exhaustive breadth-first enumeration of every schedule of the enabled
transitions (analysis/model/protocol.py) up to a depth bound, with a
visited set over canonical states so the count is states-explored,
not schedules (the schedule count is the interesting bound — the
failover scenario yields ~10^4–10^5 distinct interleavings through
~10^3–10^4 states).

Invariants are checked at EVERY reachable state, not just quiescent
ones — the write-ahead invariant in particular only bites in the
window between an ack and a crash.  BFS + parent pointers means the
first violation found is a MINIMAL counterexample schedule, which the
report renders step by step.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .protocol import Config, State, enabled, invariants, scenario

__all__ = ["Violation", "Report", "explore", "explore_scenario"]

DEFAULT_DEPTH = 24
DEFAULT_MAX_STATES = 200_000


@dataclass
class Violation:
    invariant: str
    detail: str
    trace: List[str]          # minimal schedule: one label per step
    state: State

    def format(self) -> str:
        lines = [f"INVARIANT VIOLATED: {self.invariant}",
                 f"  {self.detail}",
                 f"  minimal schedule ({len(self.trace)} steps):"]
        for i, step in enumerate(self.trace, 1):
            lines.append(f"    {i:2d}. {step}")
        return "\n".join(lines)


@dataclass
class Report:
    scenario: str
    broken: Optional[str]
    states: int = 0
    edges: int = 0
    schedules: int = 0         # distinct interleavings within the bound
    max_depth_seen: int = 0
    exhausted: bool = True     # False if depth/state bound truncated
    violation: Optional[Violation] = None

    @property
    def ok(self) -> bool:
        return self.violation is None

    def to_dict(self) -> dict:
        d = {"scenario": self.scenario, "broken": self.broken,
             "states": self.states, "edges": self.edges,
             "schedules": self.schedules,
             "max_depth": self.max_depth_seen,
             "exhausted": self.exhausted, "ok": self.ok}
        if self.violation is not None:
            d["violation"] = {
                "invariant": self.violation.invariant,
                "detail": self.violation.detail,
                "trace": self.violation.trace,
            }
        return d


def _check(state: State, cfg: Config) -> Optional[Tuple[str, str]]:
    for name, inv in invariants(cfg):
        detail = inv(state, cfg)
        if detail is not None:
            return name, detail
    return None


def _trace(parents: Dict[State, Tuple[Optional[State], str]],
           state: State) -> List[str]:
    steps: List[str] = []
    cur: Optional[State] = state
    while cur is not None:
        parent, label = parents[cur]
        if parent is None:
            break
        steps.append(label)
        cur = parent
    steps.reverse()
    return steps


def explore(cfg: Config, initial: State, *,
            depth: int = DEFAULT_DEPTH,
            max_states: int = DEFAULT_MAX_STATES,
            scenario_name: str = "?",
            broken: Optional[str] = None) -> Report:
    """BFS over every interleaving; stops at the first violation (the
    minimal one, by BFS order) or when the frontier is exhausted."""
    report = Report(scenario=scenario_name, broken=broken)
    parents: Dict[State, Tuple[Optional[State], str]] = {
        initial: (None, "")}
    queue: "deque[tuple[State, int]]" = deque([(initial, 0)])
    succ: Dict[State, List[State]] = {}
    report.states = 1

    bad = _check(initial, cfg)
    if bad is not None:
        report.violation = Violation(bad[0], bad[1], [], initial)
        return report

    while queue:
        state, d = queue.popleft()
        report.max_depth_seen = max(report.max_depth_seen, d)
        kids = enabled(state, cfg)
        succ[state] = [nxt for _l, nxt in kids]
        for label, nxt in kids:
            report.edges += 1
            if nxt in parents:
                continue
            if d >= depth:
                # a genuinely new state past the bound: the space was
                # NOT exhausted (a leaf at the bound does not truncate)
                report.exhausted = False
                continue
            parents[nxt] = (state, label)
            report.states += 1
            bad = _check(nxt, cfg)
            if bad is not None:
                report.violation = Violation(
                    bad[0], bad[1], _trace(parents, nxt), nxt)
                return report
            if report.states >= max_states:
                report.exhausted = False
                return report
            queue.append((nxt, d + 1))

    report.schedules = _count_schedules(succ, initial, depth)
    return report


def _count_schedules(succ: Dict[State, List[State]], initial: State,
                     depth: int) -> int:
    """Distinct interleavings: level-by-level path DP over the explored
    graph (not a DAG — crash/restart genuinely cycles, so schedules are
    counted within the depth bound; a path that hits the bound counts
    as one truncated schedule)."""
    level: Dict[State, int] = {initial: 1}
    total = 0
    for _d in range(depth):
        nxt: Dict[State, int] = {}
        for s, n in level.items():
            kids = succ.get(s, ())
            if not kids:
                total += n          # terminal: one complete schedule
            for k in kids:
                nxt[k] = nxt.get(k, 0) + n
        if not nxt:
            return total
        level = nxt
    return total + sum(level.values())


def explore_scenario(name: str, broken: Optional[str] = None, *,
                     depth: int = DEFAULT_DEPTH,
                     max_states: int = DEFAULT_MAX_STATES) -> Report:
    cfg, initial = scenario(name, broken)
    return explore(cfg, initial, depth=depth, max_states=max_states,
                   scenario_name=name, broken=broken)
