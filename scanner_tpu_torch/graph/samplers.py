"""Row-domain samplers and partitioners.

Capability parity: reference scanner/engine/sampler.{h,cpp} — DomainSampler
(sampler.h:39, impls sampler.cpp:33-454) and Partitioner (sampler.h:76, impls
sampler.cpp:505-742).  Semantics are bit-for-bit the reference's; the
implementation is vectorized numpy instead of per-row C++ loops.

A DomainSampler maps between a downstream (sampled) row domain and its
upstream domain.  A Partitioner splits an upstream domain into ordered groups
of rows (slice groups).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..common import GraphException


class DomainSampler:
    name = "Default"

    def upstream_rows(self, downstream_rows: np.ndarray) -> np.ndarray:
        """Minimal upstream rows needed to produce `downstream_rows`
        (sorted unique)."""
        raise NotImplementedError

    def num_downstream(self, num_upstream: int) -> int:
        """Downstream domain size given the upstream domain size."""
        raise NotImplementedError

    def downstream_map(self, upstream_rows: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Given available upstream rows (sorted), return
        (downstream_rows, mapping) where mapping[i] indexes into
        upstream_rows for downstream_rows[i], or -1 for null rows
        (reference get_downstream_rows)."""
        raise NotImplementedError


class AllSampler(DomainSampler):
    name = "All"

    def upstream_rows(self, downstream_rows):
        return np.unique(np.asarray(downstream_rows, np.int64))

    def num_downstream(self, num_upstream):
        return num_upstream

    def downstream_map(self, upstream_rows):
        upstream_rows = np.asarray(upstream_rows, np.int64)
        return upstream_rows.copy(), np.arange(len(upstream_rows))


class StridedSampler(DomainSampler):
    name = "Strided"

    def __init__(self, stride: int):
        if stride <= 0:
            raise GraphException(f"stride must be > 0, got {stride}")
        self.stride = int(stride)

    def upstream_rows(self, downstream_rows):
        return np.unique(np.asarray(downstream_rows, np.int64)) * self.stride

    def num_downstream(self, num_upstream):
        return -(-num_upstream // self.stride)

    def downstream_map(self, upstream_rows):
        upstream_rows = np.asarray(upstream_rows, np.int64)
        hit = upstream_rows % self.stride == 0
        return upstream_rows[hit] // self.stride, np.nonzero(hit)[0]


class StridedRangesSampler(DomainSampler):
    """Concatenation of strided [start, end) ranges."""

    name = "StridedRanges"

    def __init__(self, starts: Sequence[int], ends: Sequence[int],
                 stride: int = 1):
        if len(starts) != len(ends):
            raise GraphException("starts and ends must have the same length")
        if stride <= 0:
            raise GraphException(f"stride must be > 0, got {stride}")
        for s, e in zip(starts, ends):
            if s > e:
                raise GraphException(f"range start {s} after end {e}")
        self.starts = np.asarray(starts, np.int64)
        self.ends = np.asarray(ends, np.int64)
        self.stride = int(stride)
        rows_per = -(-(self.ends - self.starts) // self.stride)
        self.offsets = np.concatenate([[0], np.cumsum(rows_per)])

    def upstream_rows(self, downstream_rows):
        rows = np.unique(np.asarray(downstream_rows, np.int64))
        if len(rows) and (rows[0] < 0 or rows[-1] >= self.offsets[-1]):
            raise GraphException(
                f"row request out of bounds (max {self.offsets[-1] - 1})")
        ri = np.searchsorted(self.offsets, rows, side="right") - 1
        # overlapping ranges can map distinct downstream rows to the same
        # upstream row; keep the sorted-unique contract
        return np.unique(self.starts[ri] + (rows - self.offsets[ri])
                         * self.stride)

    def num_downstream(self, num_upstream):
        # count rows of ranges wholly or partially below num_upstream
        # (reference StridedRangesDomainSampler::get_num_downstream_rows)
        n = 0
        for s, e in zip(self.starts, self.ends):
            if num_upstream >= e:
                n += -(-(e - s) // self.stride)
            else:
                if num_upstream > s:
                    n += -(-(num_upstream - s) // self.stride)
                break
        return int(n)

    def downstream_map(self, upstream_rows):
        upstream_rows = np.asarray(upstream_rows, np.int64)
        down, mapping = [], []
        offset = 0
        range_idx = 0
        for i, r in enumerate(upstream_rows):
            while (range_idx < len(self.ends)
                   and not (self.starts[range_idx] <= r
                            < self.ends[range_idx])):
                offset += -(-(self.ends[range_idx] - self.starts[range_idx])
                            // self.stride)
                range_idx += 1
            if range_idx == len(self.ends):
                break
            rel = r - self.starts[range_idx]
            if rel % self.stride == 0:
                down.append(offset + rel // self.stride)
                mapping.append(i)
        return np.asarray(down, np.int64), np.asarray(mapping, np.int64)


class GatherSampler(DomainSampler):
    name = "Gather"

    def __init__(self, rows: Sequence[int]):
        self.rows = np.asarray(rows, np.int64)

    def upstream_rows(self, downstream_rows):
        rows = np.unique(np.asarray(downstream_rows, np.int64))
        if len(rows) and (rows[0] < 0 or rows[-1] >= len(self.rows)):
            raise GraphException(
                f"gather request out of bounds (max {len(self.rows) - 1})")
        return np.unique(self.rows[rows])

    def num_downstream(self, num_upstream):
        # prefix count up to the first out-of-range row (reference
        # GatherDomainSampler::get_num_downstream_rows breaks at it)
        n = 0
        for r in self.rows:
            if r >= num_upstream:
                break
            n += 1
        return n

    def downstream_map(self, upstream_rows):
        upstream_rows = np.asarray(upstream_rows, np.int64)
        pos = {int(r): i for i, r in enumerate(upstream_rows)}
        down, mapping = [], []
        for d, r in enumerate(self.rows):
            if int(r) in pos:
                down.append(d)
                mapping.append(pos[int(r)])
        return np.asarray(down, np.int64), np.asarray(mapping, np.int64)


class SpaceNullSampler(DomainSampler):
    """Upsample by `spacing`: source row r appears at downstream r*spacing,
    the gap filled with nulls."""

    name = "SpaceNull"

    def __init__(self, spacing: int):
        if spacing <= 0:
            raise GraphException(f"spacing must be > 0, got {spacing}")
        self.spacing = int(spacing)

    def upstream_rows(self, downstream_rows):
        return np.unique(np.asarray(downstream_rows, np.int64) // self.spacing)

    def num_downstream(self, num_upstream):
        return num_upstream * self.spacing

    def downstream_map(self, upstream_rows):
        upstream_rows = np.asarray(upstream_rows, np.int64)
        n = len(upstream_rows)
        down = (upstream_rows[:, None] * self.spacing
                + np.arange(self.spacing)[None, :]).reshape(-1)
        mapping = np.full((n, self.spacing), -1, np.int64)
        mapping[:, 0] = np.arange(n)
        return down, mapping.reshape(-1)


class SpaceRepeatSampler(DomainSampler):
    """Upsample by `spacing`, repeating each source row."""

    name = "SpaceRepeat"

    def __init__(self, spacing: int):
        if spacing <= 0:
            raise GraphException(f"spacing must be > 0, got {spacing}")
        self.spacing = int(spacing)

    def upstream_rows(self, downstream_rows):
        return np.unique(np.asarray(downstream_rows, np.int64) // self.spacing)

    def num_downstream(self, num_upstream):
        return num_upstream * self.spacing

    def downstream_map(self, upstream_rows):
        upstream_rows = np.asarray(upstream_rows, np.int64)
        n = len(upstream_rows)
        down = (upstream_rows[:, None] * self.spacing
                + np.arange(self.spacing)[None, :]).reshape(-1)
        mapping = np.repeat(np.arange(n), self.spacing)
        return down, mapping


_SAMPLERS = {
    "All": lambda args: AllSampler(),
    "Strided": lambda args: StridedSampler(args["stride"]),
    "StridedRanges": lambda args: StridedRangesSampler(
        args["starts"], args["ends"], args.get("stride", 1)),
    "Gather": lambda args: GatherSampler(args["rows"]),
    "SpaceNull": lambda args: SpaceNullSampler(args["spacing"]),
    "SpaceRepeat": lambda args: SpaceRepeatSampler(args["spacing"]),
}


def make_sampler(kind: str, args: Dict) -> DomainSampler:
    if kind not in _SAMPLERS:
        raise GraphException(f"unknown sampler: {kind}")
    return _SAMPLERS[kind](args)


# ---------------------------------------------------------------------------
# Partitioners (slice groups)
# ---------------------------------------------------------------------------

class Partitioner:
    name = "Partitioner"

    def __init__(self, num_rows: int):
        self.num_rows = int(num_rows)

    def total_groups(self) -> int:
        raise NotImplementedError

    def group_at(self, group_idx: int) -> np.ndarray:
        """Upstream rows of group `group_idx`."""
        raise NotImplementedError

    def rows_per_group(self) -> List[int]:
        return [len(self.group_at(g)) for g in range(self.total_groups())]

    def offset_at_group(self, group_idx: int) -> int:
        return int(sum(self.rows_per_group()[:group_idx]))


class StridedPartitioner(Partitioner):
    """Contiguous groups of `group_size` over the (strided) row domain
    (reference StridedPartitioner; `partitioner.all(n)` is stride=1)."""

    name = "Strided"

    def __init__(self, num_rows: int, stride: int = 1, group_size: int = 250):
        super().__init__(num_rows)
        if stride <= 0 or group_size <= 0:
            raise GraphException("stride and group_size must be > 0")
        self.stride = int(stride)
        self.group_size = int(group_size)
        self._strided_rows = -(-self.num_rows // self.stride)

    def total_groups(self):
        return -(-self._strided_rows // self.group_size)

    def group_at(self, group_idx):
        s = self.group_size * group_idx
        e = min(self._strided_rows, s + self.group_size)
        return np.arange(s, e, dtype=np.int64) * self.stride


class StridedRangePartitioner(Partitioner):
    """Each strided [start, end) range is one group (reference
    StridedRangePartitioner; overlapping ranges allowed)."""

    name = "StridedRange"

    def __init__(self, num_rows: int, starts: Sequence[int],
                 ends: Sequence[int], stride: int = 1):
        super().__init__(num_rows)
        if stride <= 0:
            raise GraphException("stride must be > 0")
        if len(starts) != len(ends):
            raise GraphException("starts/ends length mismatch")
        for s, e in zip(starts, ends):
            if s > e:
                raise GraphException(f"range start {s} after end {e}")
            if e > num_rows:
                raise GraphException(
                    f"range end {e} exceeds stream length {num_rows}")
        self.starts = list(starts)
        self.ends = list(ends)
        self.stride = int(stride)

    def total_groups(self):
        return len(self.starts)

    def group_at(self, group_idx):
        return np.arange(self.starts[group_idx], self.ends[group_idx],
                         self.stride, dtype=np.int64)


class GatherPartitioner(Partitioner):
    name = "Gather"

    def __init__(self, num_rows: int, groups: Sequence[Sequence[int]]):
        super().__init__(num_rows)
        self.groups = [np.asarray(g, np.int64) for g in groups]

    def total_groups(self):
        return len(self.groups)

    def group_at(self, group_idx):
        return self.groups[group_idx]


_PARTITIONERS = {
    "Strided": lambda n, args: StridedPartitioner(
        n, args.get("stride", 1), args.get("group_size", 250)),
    "StridedRange": lambda n, args: StridedRangePartitioner(
        n, args["starts"], args["ends"], args.get("stride", 1)),
    "Gather": lambda n, args: GatherPartitioner(n, args["groups"]),
}


def make_partitioner(kind: str, num_rows: int, args: Dict) -> Partitioner:
    if kind not in _PARTITIONERS:
        raise GraphException(f"unknown partitioner: {kind}")
    return _PARTITIONERS[kind](num_rows, args)
