"""Stream sampling/spacing/slicing DSL and IO binding.

Capability parity: reference scannerpy/streams.py (StreamsGenerator) and
io.py (sc.io.Input/Output), plus partitioner.py (TaskPartitioner).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ..common import GraphException, SliceList
from . import ops as O


def _norm_range(a) -> Dict[str, int]:
    if isinstance(a, dict):
        return {"start": int(a["start"]), "end": int(a["end"]),
                **({"stride": int(a["stride"])} if "stride" in a else {})}
    if isinstance(a, (tuple, list)) and len(a) in (2, 3):
        d = {"start": int(a[0]), "end": int(a[1])}
        if len(a) == 3:
            d["stride"] = int(a[2])
        return d
    raise GraphException(f"bad range spec: {a!r}")


def _per_stream(args, f):
    """Apply normalizer f per stream, passing SliceList through per-group."""
    out = []
    for a in args:
        if isinstance(a, SliceList):
            out.append(SliceList(f(x) for x in a))
        else:
            out.append(f(a))
    return out


class StreamsGenerator:
    """sc.streams.* — sampling ops (reference streams.py:8)."""

    def Slice(self, input: O.OpColumn, partitions: Sequence[Dict]
              ) -> O.OpColumn:
        # partitions are dicts {"kind": ..., **args} built by TaskPartitioner
        kinds = {p["kind"] for p in partitions}
        if len(kinds) != 1:
            raise GraphException("all streams must use the same partitioner")
        node = O.OpNode(O.SLICE_OP, {"col": input}, extra={
            "partitioner_kind": kinds.pop(),
            "args_per_stream": [
                {k: v for k, v in p.items() if k != "kind"}
                for p in partitions]})
        return node.outputs[0]

    def Unslice(self, input: O.OpColumn) -> O.OpColumn:
        return O.OpNode(O.UNSLICE_OP, {"col": input}).outputs[0]

    def _sample(self, input: O.OpColumn, kind: str, args_per_stream
                ) -> O.OpColumn:
        node = O.OpNode(O.SAMPLE_OP, {"col": input}, extra={
            "sampler_kind": kind, "args_per_stream": args_per_stream})
        return node.outputs[0]

    def _space(self, input: O.OpColumn, kind: str, args_per_stream
               ) -> O.OpColumn:
        node = O.OpNode(O.SPACE_OP, {"col": input}, extra={
            "sampler_kind": kind, "args_per_stream": args_per_stream})
        return node.outputs[0]

    def All(self, input: O.OpColumn) -> O.OpColumn:
        # identity; still an op so per-stream arg counts line up
        return self._sample(input, "All", None)

    def Stride(self, input: O.OpColumn, strides: Sequence) -> O.OpColumn:
        def norm(a):
            return {"stride": int(a["stride"] if isinstance(a, dict) else a)}
        return self._sample(input, "Strided", _per_stream(strides, norm))

    def Range(self, input: O.OpColumn, ranges: Sequence) -> O.OpColumn:
        def norm(a):
            d = _norm_range(a)
            return {"starts": [d["start"]], "ends": [d["end"]], "stride": 1}
        return self._sample(input, "StridedRanges", _per_stream(ranges, norm))

    def Ranges(self, input: O.OpColumn, intervals: Sequence) -> O.OpColumn:
        def norm(iv):
            rs = [_norm_range(x) for x in iv]
            return {"starts": [r["start"] for r in rs],
                    "ends": [r["end"] for r in rs], "stride": 1}
        return self._sample(input, "StridedRanges",
                            _per_stream(intervals, norm))

    def StridedRange(self, input: O.OpColumn, ranges: Sequence) -> O.OpColumn:
        def norm(a):
            d = _norm_range(a)
            return {"starts": [d["start"]], "ends": [d["end"]],
                    "stride": d.get("stride", 1)}
        return self._sample(input, "StridedRanges", _per_stream(ranges, norm))

    def StridedRanges(self, input: O.OpColumn, intervals: Sequence = None,
                      stride: int = 1) -> O.OpColumn:
        if intervals is None:
            raise GraphException(
                "StridedRanges requires intervals (one list per stream)")
        def norm(iv):
            rs = [_norm_range(x) for x in iv]
            return {"starts": [r["start"] for r in rs],
                    "ends": [r["end"] for r in rs], "stride": stride}
        return self._sample(input, "StridedRanges",
                            _per_stream(intervals, norm))

    def Gather(self, input: O.OpColumn, indices: Sequence[Sequence[int]],
               **kw) -> O.OpColumn:
        def norm(rows):
            return {"rows": [int(r) for r in rows]}
        return self._sample(input, "Gather", _per_stream(indices, norm))

    def RepeatNull(self, input: O.OpColumn, spacings: Sequence) -> O.OpColumn:
        def norm(a):
            return {"spacing": int(a)}
        return self._space(input, "SpaceNull", _per_stream(spacings, norm))

    def Repeat(self, input: O.OpColumn, spacings: Sequence) -> O.OpColumn:
        def norm(a):
            return {"spacing": int(a)}
        return self._space(input, "SpaceRepeat", _per_stream(spacings, norm))


class TaskPartitioner:
    """sc.partitioner.* — slice partition specs (reference partitioner.py).
    Returns plain dicts consumed by streams.Slice."""

    DEFAULT_GROUP_SIZE = 250

    def all(self, group_size: int = DEFAULT_GROUP_SIZE) -> Dict:
        return self.strided(1, group_size)

    def strided(self, stride: int,
                group_size: int = DEFAULT_GROUP_SIZE) -> Dict:
        return {"kind": "Strided", "stride": stride, "group_size": group_size}

    def range(self, start: int, end: int) -> Dict:
        return self.ranges([(start, end)])

    def ranges(self, intervals) -> Dict:
        return self.strided_ranges(intervals, 1)

    def strided_range(self, start: int, end: int, stride: int) -> Dict:
        return self.strided_ranges([(start, end)], stride)

    def strided_ranges(self, intervals, stride: int = 1) -> Dict:
        return {"kind": "StridedRange",
                "starts": [int(i[0]) for i in intervals],
                "ends": [int(i[1]) for i in intervals],
                "stride": stride}

    def gather(self, groups: Sequence[Sequence[int]]) -> Dict:
        return {"kind": "Gather", "groups": [list(g) for g in groups]}


class IOGenerator:
    """sc.io.Input / sc.io.Output (reference io.py:4-24)."""

    def __init__(self, sc=None):
        self._sc = sc

    def Input(self, streams: Sequence) -> O.OpColumn:
        if not streams:
            raise GraphException("io.Input needs at least one stream")
        node = O.OpNode(O.INPUT_OP, {}, extra={"streams": list(streams)})
        node.outputs[0].is_frame = bool(
            getattr(streams[0], "is_video", False))
        return node.outputs[0]

    def Output(self, op: Union[O.OpColumn, O.OpNode],
               streams: Sequence) -> O.OpNode:
        if isinstance(op, O.OpNode):
            if len(op.outputs) != 1:
                raise GraphException(
                    "io.Output needs a single column; select one")
            op = op.outputs[0]
        node = O.OpNode(O.OUTPUT_OP, {"col": op},
                        extra={"streams": list(streams),
                               "encode_options": dict(op.encode_options)})
        return node
