"""Exact-frame decode planning and execution.

Capability parity: reference DecoderAutomata (decoder_automata.h:28-88,
decoder_automata.cpp:72-238) — turn "give me display frames {i...}" into
minimal keyframe-aligned packet feeds, decode them, and deliver exactly the
requested frames.

Instead of the reference's two-thread feeder/retriever state machine, the
whole run executes inside one C call (scvid_decode_run) with a wanted-frame
mask; parallelism comes from running many automata on separate Python threads
(the C side releases the GIL).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..common import ScannerException
from ..storage.backend import StorageBackend
from ..storage.metadata import VideoDescriptor
from .lib import Decoder


@dataclass
class DecodeRun:
    """One keyframe-aligned packet feed."""
    start_dec: int       # first packet (decode order), always a keyframe
    end_dec: int         # last packet fed, inclusive
    out_disp: np.ndarray  # display indices delivered, ascending


class VideoIndex:
    """Derived lookup structures over a VideoDescriptor's sample index."""

    def __init__(self, vd: VideoDescriptor):
        self.vd = vd
        n = vd.num_frames
        pts = np.asarray(vd.sample_pts)
        # decode indices sorted by presentation time = display order
        self.dec_of_disp = np.argsort(pts, kind="stable").astype(np.int64)
        self.disp_of_dec = np.empty(n, np.int64)
        self.disp_of_dec[self.dec_of_disp] = np.arange(n)
        # feeding packets [0..M[d]] guarantees display frames [0..d] emitted
        self.max_dec_through_disp = np.maximum.accumulate(self.dec_of_disp)
        self.kf_decs = np.asarray(vd.keyframe_indices)
        self.kf_disps = self.disp_of_dec[self.kf_decs]
        if not np.all(np.diff(self.kf_disps) > 0):
            # sort keyframes by display position (defensive; decode order
            # keyframes are display-ordered for closed-GOP streams)
            order = np.argsort(self.kf_disps)
            self.kf_decs = self.kf_decs[order]
            self.kf_disps = self.kf_disps[order]

    def governing_keyframe(self, disp: int) -> Tuple[int, int]:
        """(keyframe decode idx, keyframe display idx) for a display frame."""
        i = int(np.searchsorted(self.kf_disps, disp, side="right")) - 1
        if i < 0:
            raise ScannerException(f"no keyframe before display frame {disp}")
        return int(self.kf_decs[i]), int(self.kf_disps[i])

    def plan(self, wanted_disp: Sequence[int],
             decode_through: int = 16) -> List[DecodeRun]:
        """Build minimal decode runs covering `wanted_disp` (sorted unique).

        decode_through: if the next wanted frame's keyframe starts within
        this many packets of the current run's end, keep decoding through
        rather than reseeking — a reseek costs a codec flush and re-reads.
        """
        wanted = np.unique(np.asarray(list(wanted_disp), dtype=np.int64))
        if len(wanted) == 0:
            return []
        if wanted[0] < 0 or wanted[-1] >= self.vd.num_frames:
            raise ScannerException(
                f"frame request {wanted[0]}..{wanted[-1]} out of range "
                f"(video has {self.vd.num_frames} frames)")
        runs: List[DecodeRun] = []
        cur_start = cur_end = -1
        cur_disps: List[int] = []

        def close_run():
            if cur_start < 0:
                return
            runs.append(DecodeRun(cur_start, cur_end,
                                  np.asarray(cur_disps, np.int64)))

        for w in wanted:
            kf_dec, kf_disp = self.governing_keyframe(int(w))
            need_end = int(self.max_dec_through_disp[w])
            if cur_start >= 0 and kf_dec <= cur_end + decode_through:
                cur_end = max(cur_end, need_end)
                cur_disps.append(int(w))
            else:
                close_run()
                cur_start, cur_end = kf_dec, need_end
                cur_disps = [int(w)]
        close_run()
        return runs


class DecoderAutomata:
    """Owns one Decoder handle and executes decode plans against stored
    packet data."""

    def __init__(self, backend: StorageBackend, vd: VideoDescriptor,
                 data_path: str, n_threads: int = 1,
                 output_format: str = "rgb24"):
        self.backend = backend
        self.vd = vd
        self.index = VideoIndex(vd)
        # in-place ingested streams read from the original container file
        self.data_path = vd.data_path or data_path
        self._external = bool(vd.data_path)
        # "rgb24": (n, h, w, 3) frames; "yuv420": (n, frame_bytes) planar
        # I420 rows at 1.5 B/px for device-side conversion
        # (kernels/color.py) — half the host->device bytes
        self.output_format = output_format
        self.decoder = Decoder(vd.codec, vd.extradata, vd.width, vd.height,
                               n_threads, output_format=output_format)
        # reused decode scratch (grown geometrically) — avoids a fresh
        # multi-MB allocation per decode run (reference keeps pooled
        # buffers for the same reason, util/memory.cpp BlockAllocator)
        self._scratch = np.empty(0, np.uint8)

    @property
    def frame_bytes(self) -> int:
        from .lib import yuv420_frame_bytes
        if self.output_format == "yuv420":
            return yuv420_frame_bytes(self.vd.height, self.vd.width)
        return self.vd.height * self.vd.width * 3

    def _scratch_buf(self, nbytes: int) -> np.ndarray:
        if self._scratch.nbytes < nbytes:
            self._scratch = np.empty(int(nbytes * 1.5) + 1, np.uint8)
        return self._scratch

    def close(self):
        self.decoder.close()
        self._scratch = np.empty(0, np.uint8)

    def _read_packets(self, start_dec: int, end_dec: int
                      ) -> Tuple[bytes, np.ndarray]:
        offs = self.vd.sample_offsets[start_dec:end_dec + 1].astype(np.int64)
        sizes = self.vd.sample_sizes[start_dec:end_dec + 1].astype(np.int64)
        if self._external:
            # external container: samples may be non-contiguous; one spanning
            # read then slice (containers interleave audio but video spans
            # are still compact enough)
            lo = int(offs.min())
            hi = int((offs + sizes).max())
            with open(self.data_path, "rb") as f:
                f.seek(lo)
                span = f.read(hi - lo)
            parts = [span[o - lo:o - lo + s] for o, s in zip(offs, sizes)]
            return b"".join(parts), sizes.astype(np.uint64)
        # packed stream: contiguous by construction
        lo = int(offs[0])
        hi = int(offs[-1] + sizes[-1])
        data = self.backend.read_range(self.data_path, lo, hi - lo)
        if len(data) != hi - lo:
            raise ScannerException(
                f"short packet read from {self.data_path}")
        return data, sizes.astype(np.uint64)

    def _decode_run_pts(self, run: DecodeRun, out: np.ndarray) -> None:
        """Decode one run into `out` ((n_out, h*w*3) rows in display
        order), selecting frames by TIMESTAMP rather than emission
        position.  Pts matching keeps delivery exact on streams where
        positional masks break: open-GOP seeks (the decoder emits or
        drops leading frames whose references precede the keyframe) and
        VFR containers (display order is defined by pts alone).  If a
        wanted frame is not delivered — an open-GOP leading frame whose
        references live in the previous GOP — the whole run retries from
        one keyframe earlier until it decodes or the stream start is hit
        (reference decoder_automata feeder restarts at decoder_automata
        .cpp:238; the reference never handled open GOPs at all)."""
        h, w = self.vd.height, self.vd.width
        pts_all = np.asarray(self.vd.sample_pts, np.int64)
        wanted_pts = pts_all[self.index.dec_of_disp[
            np.asarray(run.out_disp, np.int64)]]
        start = run.start_dec
        while True:
            data, sizes = self._read_packets(start, run.end_dec)
            pkt_pts = pts_all[start:run.end_dec + 1]
            self.decoder.reset()
            n, oh, ow, deliv = self.decoder.decode_run_pts(
                data, sizes, pkt_pts, wanted_pts, out, flush=True)
            if n and (oh, ow) != (h, w):
                raise ScannerException(
                    f"decoded geometry {oh}x{ow} != descriptor {h}x{w}")
            if deliv.all():
                return
            # open-GOP leading frames: restart from one keyframe earlier
            ki = int(np.searchsorted(self.index.kf_decs, start,
                                     side="right")) - 1
            if ki <= 0 or start <= 0:
                missing = wanted_pts[~deliv].tolist()
                raise ScannerException(
                    f"frames with pts {missing[:5]} not delivered "
                    f"(run {start}..{run.end_dec}; stream damaged or "
                    f"index stale)")
            start = int(self.index.kf_decs[ki - 1])

    def stream_frames(self, rows: Sequence[int], packets_per_call: int = 16,
                      max_frames_per_yield: int = 16):
        """Incrementally decode ascending unique display rows, yielding
        ``(row_array, frames_array)`` slices as the codec emits them.

        One decode session per keyframe run: packets are fed in slices of
        ``packets_per_call`` through repeated bounded
        ``decode_run_pts_stream`` calls WITHOUT resetting the codec (the
        C layer stops — does not error — at ``max_frames_per_yield``
        matched frames and reports the packets it consumed, so the
        output buffer is a work packet, not a packet run plus a
        reorder-delay margin).  Peak memory is one yield slice.  This is
        the work-packet streaming loader's decode primitive (reference
        element cache + feeder threads, evaluate_worker.h:207-218 /
        decoder_automata.cpp).  Frames arrive in display order; yields
        are disjoint and cover exactly `rows`.  Open-GOP / false-keyframe
        retries restart the run from an earlier keyframe for the
        still-undelivered tail only.
        """
        rows_arr = np.unique(np.asarray(list(rows), np.int64))
        if len(rows_arr) == 0:
            return
        frame_bytes = self.frame_bytes
        shape_tail = ((self.vd.height, self.vd.width, 3)
                      if self.output_format == "rgb24" else (frame_bytes,))
        pts_all = np.asarray(self.vd.sample_pts, np.int64)
        empty_sizes = np.zeros(0, np.uint64)
        empty_pts = np.zeros(0, np.int64)
        for run in self.index.plan(rows_arr):
            out_disp = np.asarray(run.out_disp, np.int64)
            start = run.start_dec
            while True:  # open-GOP / false-keyframe retry loop
                rem_rows = out_disp
                rem_pts = pts_all[self.index.dec_of_disp[rem_rows]]
                self.decoder.reset()
                pos = start
                while len(rem_rows):
                    if pos <= run.end_dec:
                        end = min(pos + packets_per_call - 1, run.end_dec)
                        data, sizes = self._read_packets(pos, end)
                        pkt_pts = pts_all[pos:end + 1]
                    else:
                        # flush-only continuation: harvest codec backlog
                        data, sizes, pkt_pts = b"", empty_sizes, empty_pts
                        end = pos - 1
                    buf = self._scratch_buf(
                        max_frames_per_yield * frame_bytes)
                    n, oh, ow, deliv, consumed = \
                        self.decoder.decode_run_pts_stream(
                            data, sizes, pkt_pts, rem_pts,
                            buf[:max_frames_per_yield * frame_bytes],
                            max_frames=max_frames_per_yield,
                            flush=(end >= run.end_dec))
                    if n and (oh, ow) != (self.vd.height, self.vd.width):
                        raise ScannerException(
                            f"decoded geometry {oh}x{ow} != descriptor "
                            f"{self.vd.height}x{self.vd.width}")
                    if n:
                        got = buf[:n * frame_bytes].reshape(
                            (n,) + shape_tail).copy()
                        yield rem_rows[deliv], got
                    rem_rows = rem_rows[~deliv]
                    rem_pts = rem_pts[~deliv]
                    pos += consumed
                    if pos > run.end_dec and n == 0 and consumed == 0:
                        break  # flushed dry; tail undeliverable here
                if not len(rem_rows):
                    break
                # leading open-GOP frames (or a false keyframe): retry the
                # undelivered tail from one keyframe earlier
                out_disp = rem_rows
                ki = int(np.searchsorted(self.index.kf_decs, start,
                                         side="right")) - 1
                if ki <= 0 or start <= 0:
                    raise ScannerException(
                        f"frames with pts {rem_pts[:5].tolist()} not "
                        f"delivered (run {start}..{run.end_dec}; stream "
                        f"damaged or index stale)")
                start = int(self.index.kf_decs[ki - 1])

    def get_frames(self, rows: Sequence[int]) -> np.ndarray:
        """Decode exactly the given display-order frame indices.

        Returns uint8 array in *request order* — duplicates and arbitrary
        order allowed (Gather semantics).  Shape is
        (len(rows), h, w, 3) for "rgb24" output, or
        (len(rows), frame_bytes) planar I420 rows for "yuv420".
        """
        rows_arr = np.asarray(list(rows), np.int64)
        h, w = self.vd.height, self.vd.width
        frame_bytes = self.frame_bytes
        shape = ((len(rows_arr), h, w, 3)
                 if self.output_format == "rgb24"
                 else (len(rows_arr), frame_bytes))
        if len(rows_arr) == 0:
            return np.zeros(shape, np.uint8)
        runs = self.index.plan(rows_arr)
        result = np.empty(shape, np.uint8)
        if len(runs) == 1 and np.array_equal(
                np.asarray(runs[0].out_disp, np.int64), rows_arr):
            # fast path: the run emits exactly the requested rows in
            # request order — decode straight into the result batch (the
            # zero-copy head of the engine's batched column path)
            self._decode_run_pts(runs[0], result.reshape(-1))
            return result
        # request-order positions of each decoded display index
        positions: dict = {}
        for i, r in enumerate(rows_arr.tolist()):
            positions.setdefault(int(r), []).append(i)
        for run in runs:
            n_out = len(run.out_disp)
            scratch = self._scratch_buf(n_out * frame_bytes)
            out = scratch[:n_out * frame_bytes]
            self._decode_run_pts(run, out)
            out = out.reshape((n_out,) + shape[1:])
            for i, d in enumerate(run.out_disp):
                for pos in positions.get(int(d), ()):
                    result[pos] = out[i]
        return result
