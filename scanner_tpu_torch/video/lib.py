"""ctypes bindings for libscvid (cpp/scvid.cpp).

Every call into the library releases the GIL, so one Python process can run
many decoder handles truly in parallel — the replacement for the reference's
decoder thread pool (decoder_automata.cpp feeder threads, worker.cpp:1631
decoder_cpus).
"""

from __future__ import annotations

import ctypes as C
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import native
from ..common import ScannerException
from ..storage.metadata import VideoDescriptor

_CPP_DIR = os.path.join(native.REPO_DIR, "cpp")
# the flags and libraries of cpp/Makefile's libscvid.so rule
_CXXFLAGS = ["-O2", "-fPIC", "-std=c++17", "-Wall", "-fvisibility=hidden"]
_LDLIBS = ["-lavformat", "-lavcodec", "-lavutil", "-lswscale"]

# Must match scvid_api_version() in cpp/scvid.cpp.  Bumped together with
# any exported-symbol or struct-layout change so a stale prebuilt .so is
# refused with a clear "rebuild" error instead of a late AttributeError
# on a missing symbol (advisor round-4 finding).
_API_VERSION = 3


class _Index(C.Structure):
    _fields_ = [
        ("width", C.c_int32),
        ("height", C.c_int32),
        ("fps", C.c_double),
        ("num_samples", C.c_int64),
        ("codec", C.c_char * 32),
        ("tb_num", C.c_int32),
        ("tb_den", C.c_int32),
        ("sample_offsets", C.POINTER(C.c_uint64)),
        ("sample_sizes", C.POINTER(C.c_uint64)),
        ("sample_pts", C.POINTER(C.c_int64)),
        ("sample_dts", C.POINTER(C.c_int64)),
        ("keyflags", C.POINTER(C.c_uint8)),
        ("extradata", C.POINTER(C.c_uint8)),
        ("extradata_size", C.c_int64),
    ]


_lib = None


def _lib_version(handle) -> int:
    try:
        handle.scvid_api_version.restype = C.c_int32
        return int(handle.scvid_api_version())
    except AttributeError:
        return -1


def _load_checked():
    """Build libscvid from cpp/scvid.cpp into the port's build directory
    (native.build_shared: flock-serialized, atomic rename) and CDLL it,
    verifying the API version.  Raises with a clear message when no good
    library can be produced."""
    src = os.path.join(_CPP_DIR, "scvid.cpp")
    hdr = os.path.join(_CPP_DIR, "scvid_api.h")
    try:
        path = native.build_shared(
            "libscvid.so", [src, hdr],
            ["g++", *_CXXFLAGS, "-shared", src, "-o", "{out}", *_LDLIBS])
    except native.BuildError as e:
        raise ScannerException(str(e)) from e
    lib = C.CDLL(path)
    got = _lib_version(lib)
    if got != _API_VERSION:
        raise ScannerException(
            f"libscvid API version {got} at {path}, need {_API_VERSION}")
    return lib


def get_lib():
    global _lib
    if _lib is None:
        lib = _load_checked()
        lib.scvid_last_error.restype = C.c_char_p
        lib.scvid_set_log_level.argtypes = [C.c_int]
        lib.scvid_ingest.restype = C.POINTER(_Index)
        lib.scvid_ingest.argtypes = [C.c_char_p, C.c_char_p]
        lib.scvid_index_free.argtypes = [C.POINTER(_Index)]
        lib.scvid_decoder_create.restype = C.c_void_p
        lib.scvid_decoder_create.argtypes = [
            C.c_char_p, C.c_char_p, C.c_int64, C.c_int32, C.c_int32, C.c_int32]
        lib.scvid_decoder_destroy.argtypes = [C.c_void_p]
        lib.scvid_decoder_reset.argtypes = [C.c_void_p]
        lib.scvid_decoder_set_output_format.argtypes = [C.c_void_p,
                                                        C.c_int32]
        lib.scvid_decode_run.restype = C.c_int64
        lib.scvid_decode_run.argtypes = [
            C.c_void_p, C.c_char_p, C.POINTER(C.c_uint64), C.c_int64,
            C.c_char_p, C.c_int64, C.c_int32, C.c_void_p, C.c_int64,
            C.POINTER(C.c_int64)]
        lib.scvid_decode_run_pts.restype = C.c_int64
        lib.scvid_decode_run_pts.argtypes = [
            C.c_void_p, C.c_char_p, C.POINTER(C.c_uint64),
            C.POINTER(C.c_int64), C.c_int64, C.POINTER(C.c_int64),
            C.c_int64, C.c_char_p, C.c_int32, C.c_void_p, C.c_int64,
            C.POINTER(C.c_int64)]
        lib.scvid_decoder_emitted.restype = C.c_int64
        lib.scvid_decoder_emitted.argtypes = [C.c_void_p]
        lib.scvid_decode_run_pts_stream.restype = C.c_int64
        lib.scvid_decode_run_pts_stream.argtypes = [
            C.c_void_p, C.c_char_p, C.POINTER(C.c_uint64),
            C.POINTER(C.c_int64), C.c_int64, C.POINTER(C.c_int64),
            C.c_int64, C.c_char_p, C.c_int32, C.c_int64, C.c_void_p,
            C.c_int64, C.POINTER(C.c_int64), C.POINTER(C.c_int64)]
        lib.scvid_encoder_create.restype = C.c_void_p
        lib.scvid_encoder_create.argtypes = [
            C.c_int32, C.c_int32, C.c_int32, C.c_int32, C.c_char_p,
            C.c_int64, C.c_int32, C.c_int32, C.c_int32, C.c_int32]
        lib.scvid_encoder_destroy.argtypes = [C.c_void_p]
        lib.scvid_encoder_extradata.restype = C.c_int64
        lib.scvid_encoder_extradata.argtypes = [C.c_void_p, C.c_void_p,
                                                C.c_int64]
        lib.scvid_encoder_descriptor.restype = C.c_char_p
        lib.scvid_encoder_descriptor.argtypes = [C.c_void_p]
        lib.scvid_encoder_feed.restype = C.c_int32
        lib.scvid_encoder_feed.argtypes = [C.c_void_p, C.c_void_p, C.c_int64]
        lib.scvid_encoder_feed_pts.restype = C.c_int32
        lib.scvid_encoder_feed_pts.argtypes = [
            C.c_void_p, C.c_void_p, C.c_int64, C.POINTER(C.c_int64)]
        lib.scvid_encoder_flush.restype = C.c_int32
        lib.scvid_encoder_flush.argtypes = [C.c_void_p]
        lib.scvid_encoder_pending.restype = C.c_int64
        lib.scvid_encoder_pending.argtypes = [C.c_void_p]
        lib.scvid_encoder_pending_bytes.restype = C.c_int64
        lib.scvid_encoder_pending_bytes.argtypes = [C.c_void_p]
        lib.scvid_encoder_take.argtypes = [
            C.c_void_p, C.c_void_p, C.POINTER(C.c_uint64), C.c_void_p,
            C.POINTER(C.c_int64), C.POINTER(C.c_int64)]
        lib.scvid_mp4_write.restype = C.c_int32
        lib.scvid_mp4_write.argtypes = [
            C.c_char_p, C.c_int32, C.c_int32, C.c_int32, C.c_int32,
            C.c_int32, C.c_int32,
            C.c_char_p, C.c_char_p, C.c_int64, C.c_char_p,
            C.POINTER(C.c_uint64), C.c_char_p, C.POINTER(C.c_int64),
            C.POINTER(C.c_int64), C.c_int64]
        lib.scvid_set_log_level(16)  # AV_LOG_ERROR
        _lib = lib
    return _lib


def _err() -> str:
    return get_lib().scvid_last_error().decode("utf-8", "replace")


def ingest_file(path: str, out_packets_path: Optional[str]
                ) -> VideoDescriptor:
    """Demux a video file into (packet stream, index).

    out_packets_path=None performs in-place ingest: the index references the
    original container (reference ingest.cpp:382 parse_video_inplace).
    """
    lib = get_lib()
    idx_p = lib.scvid_ingest(
        path.encode(), out_packets_path.encode() if out_packets_path else None)
    if not idx_p:
        raise ScannerException(f"ingest failed for {path}: {_err()}")
    idx = idx_p.contents
    n = idx.num_samples
    try:
        vd = VideoDescriptor(
            width=idx.width, height=idx.height, fps=idx.fps, num_frames=n,
            codec=idx.codec.decode(),
            extradata=bytes(
                C.cast(idx.extradata,
                       C.POINTER(C.c_uint8 * idx.extradata_size)).contents)
            if idx.extradata_size > 0 else b"",
            sample_offsets=np.ctypeslib.as_array(idx.sample_offsets,
                                                 (n,)).copy(),
            sample_sizes=np.ctypeslib.as_array(idx.sample_sizes, (n,)).copy(),
            keyframe_indices=np.nonzero(
                np.ctypeslib.as_array(idx.keyflags, (n,)))[0].astype(np.int64),
            sample_pts=np.ctypeslib.as_array(idx.sample_pts, (n,)).copy(),
            sample_dts=np.ctypeslib.as_array(idx.sample_dts, (n,)).copy(),
            tb_num=idx.tb_num, tb_den=idx.tb_den,
            data_path=os.path.abspath(path) if out_packets_path is None else "")
    finally:
        lib.scvid_index_free(idx_p)
    if len(vd.keyframe_indices) == 0 or vd.keyframe_indices[0] != 0:
        raise ScannerException(
            f"{path}: stream does not start with a keyframe")
    return vd


def yuv420_frame_bytes(height: int, width: int) -> int:
    """Bytes per planar I420 frame (Y + quarter-res U and V planes)."""
    ch, cw = (height + 1) // 2, (width + 1) // 2
    return height * width + 2 * ch * cw


class Decoder:
    """One hardware-thread decode pipeline. Not thread-safe per-instance;
    use one per worker thread.

    output_format selects the decoded pixel layout:
      - "rgb24"  (default): packed (h, w, 3) — host conversion via swscale
      - "yuv420": planar I420, yuv420_frame_bytes(h, w) per frame — for
        pipelines that ship 1.5 B/px to an accelerator and convert there
        (kernels/color.py; the reference shipped NV12 and converted
        on-GPU for the same halving, util/image.cu:22)
    """

    def __init__(self, codec: str, extradata: bytes, width: int, height: int,
                 n_threads: int = 1, output_format: str = "rgb24"):
        self._lib = get_lib()
        self._h = self._lib.scvid_decoder_create(
            codec.encode(), extradata, len(extradata), width, height,
            n_threads)
        if not self._h:
            raise ScannerException(f"decoder create failed: {_err()}")
        if output_format not in ("rgb24", "yuv420"):
            self._lib.scvid_decoder_destroy(self._h)
            self._h = None
            raise ScannerException(
                f"unknown decoder output_format {output_format!r}")
        self.output_format = output_format
        if output_format == "yuv420":
            self._lib.scvid_decoder_set_output_format(self._h, 1)

    def close(self):
        if self._h:
            self._lib.scvid_decoder_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def reset(self):
        self._lib.scvid_decoder_reset(self._h)

    def decode_run(self, packets: bytes, sizes: np.ndarray,
                   wanted: np.ndarray, out: np.ndarray,
                   flush: bool = True) -> Tuple[int, int, int]:
        """Decode a packet run; write frames selected by `wanted` (uint8 mask
        over emitted frames since last reset) into `out` (flat uint8).
        Returns (n_written, height, width)."""
        sizes = np.ascontiguousarray(sizes, dtype=np.uint64)
        wanted = np.ascontiguousarray(wanted, dtype=np.uint8)
        assert out.dtype == np.uint8 and out.flags["C_CONTIGUOUS"]
        dims = (C.c_int64 * 2)()
        n = self._lib.scvid_decode_run(
            self._h, packets,
            sizes.ctypes.data_as(C.POINTER(C.c_uint64)), len(sizes),
            wanted.ctypes.data_as(C.c_char_p), len(wanted),
            1 if flush else 0,
            out.ctypes.data_as(C.c_void_p), out.nbytes, dims)
        if n < 0:
            raise ScannerException(f"decode failed: {_err()}")
        return int(n), int(dims[0]), int(dims[1])

    def decode_run_pts_stream(self, packets: bytes, sizes: np.ndarray,
                              pkt_pts: np.ndarray, wanted_pts: np.ndarray,
                              out: np.ndarray, max_frames: int,
                              flush: bool = False
                              ) -> Tuple[int, int, int, np.ndarray, int]:
        """Resumable bounded decode (scvid_decode_run_pts_stream): write
        at most `max_frames` matched frames, report packets consumed so
        the caller re-feeds the rest.  Codec state is NOT reset between
        calls — the work-packet streaming primitive."""
        sizes = np.ascontiguousarray(sizes, dtype=np.uint64)
        pkt_pts = np.ascontiguousarray(pkt_pts, dtype=np.int64)
        wanted_pts = np.ascontiguousarray(wanted_pts, dtype=np.int64)
        assert out.dtype == np.uint8 and out.flags["C_CONTIGUOUS"]
        deliv = np.zeros(len(wanted_pts), np.uint8)
        dims = (C.c_int64 * 2)()
        consumed = C.c_int64(0)
        n = self._lib.scvid_decode_run_pts_stream(
            self._h, packets,
            sizes.ctypes.data_as(C.POINTER(C.c_uint64)),
            pkt_pts.ctypes.data_as(C.POINTER(C.c_int64)), len(sizes),
            wanted_pts.ctypes.data_as(C.POINTER(C.c_int64)),
            len(wanted_pts),
            deliv.ctypes.data_as(C.c_char_p),
            1 if flush else 0, int(max_frames),
            out.ctypes.data_as(C.c_void_p), out.nbytes, dims,
            C.byref(consumed))
        if n < 0:
            raise ScannerException(f"decode failed: {_err()}")
        return (int(n), int(dims[0]), int(dims[1]), deliv.astype(bool),
                int(consumed.value))

    def decode_run_pts(self, packets: bytes, sizes: np.ndarray,
                       pkt_pts: np.ndarray, wanted_pts: np.ndarray,
                       out: np.ndarray, flush: bool = True
                       ) -> Tuple[int, int, int, np.ndarray]:
        """Decode a packet run selecting frames by TIMESTAMP membership
        (robust to open-GOP leading frames and VFR streams; see
        scvid_decode_run_pts).  wanted_pts must be sorted ascending,
        unique.  Returns (n_written, height, width, delivered_mask);
        missing timestamps are reported in the mask, not raised — the
        caller replans (e.g. from an earlier keyframe)."""
        sizes = np.ascontiguousarray(sizes, dtype=np.uint64)
        pkt_pts = np.ascontiguousarray(pkt_pts, dtype=np.int64)
        wanted_pts = np.ascontiguousarray(wanted_pts, dtype=np.int64)
        assert out.dtype == np.uint8 and out.flags["C_CONTIGUOUS"]
        deliv = np.zeros(len(wanted_pts), np.uint8)
        dims = (C.c_int64 * 2)()
        n = self._lib.scvid_decode_run_pts(
            self._h, packets,
            sizes.ctypes.data_as(C.POINTER(C.c_uint64)),
            pkt_pts.ctypes.data_as(C.POINTER(C.c_int64)), len(sizes),
            wanted_pts.ctypes.data_as(C.POINTER(C.c_int64)),
            len(wanted_pts),
            deliv.ctypes.data_as(C.c_char_p),
            1 if flush else 0,
            out.ctypes.data_as(C.c_void_p), out.nbytes, dims)
        if n < 0:
            raise ScannerException(f"decode failed: {_err()}")
        return int(n), int(dims[0]), int(dims[1]), deliv.astype(bool)


class Encoder:
    def __init__(self, width: int, height: int, fps: float = 30.0,
                 codec: str = "libx264", bitrate: int = 0, crf: int = 20,
                 keyint: int = 16, bframes: int = 0,
                 open_gop: bool = False):
        self._lib = get_lib()
        fps_num, fps_den = _fps_to_rational(fps)
        self.width, self.height = width, height
        self.fps_num, self.fps_den = fps_num, fps_den
        self._h = self._lib.scvid_encoder_create(
            width, height, fps_num, fps_den, codec.encode(), bitrate, crf,
            keyint, bframes, 1 if open_gop else 0)
        if not self._h:
            raise ScannerException(f"encoder create failed: {_err()}")

    def close(self):
        if self._h:
            self._lib.scvid_encoder_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def extradata(self) -> bytes:
        n = self._lib.scvid_encoder_extradata(self._h, None, 0)
        if n == 0:
            return b""
        buf = C.create_string_buffer(n)
        self._lib.scvid_encoder_extradata(self._h, buf, n)
        return buf.raw

    @property
    def descriptor(self) -> str:
        """Container-level codec descriptor of this encoder's output
        ("h264", "hevc", ...) — the name write_mp4 and the ingest index
        agree on, straight from libavcodec (no name mapping)."""
        return self._lib.scvid_encoder_descriptor(self._h).decode()

    def feed(self, frames: np.ndarray,
             pts: Optional[np.ndarray] = None) -> None:
        """frames: uint8 array (n, h, w, 3) or (h, w, 3).

        pts (optional): per-frame presentation timestamps in the encoder
        time base (1/fps ticks), strictly increasing across all feeds —
        gaps produce variable-frame-rate streams."""
        frames = np.ascontiguousarray(frames, dtype=np.uint8)
        if frames.ndim == 3:
            frames = frames[None]
        if frames.shape[1:] != (self.height, self.width, 3):
            raise ScannerException(
                f"encoder expects {self.height}x{self.width}x3 frames, got "
                f"{frames.shape[1:]}")
        n = frames.shape[0]
        if pts is None:
            ok = self._lib.scvid_encoder_feed(
                self._h, frames.ctypes.data_as(C.c_void_p), n)
        else:
            pts = np.ascontiguousarray(pts, dtype=np.int64)
            if len(pts) != n:
                raise ScannerException(
                    f"{len(pts)} timestamps for {n} frames")
            ok = self._lib.scvid_encoder_feed_pts(
                self._h, frames.ctypes.data_as(C.c_void_p), n,
                pts.ctypes.data_as(C.POINTER(C.c_int64)))
        if ok < 0:
            raise ScannerException(f"encode failed: {_err()}")

    def flush(self) -> None:
        if self._lib.scvid_encoder_flush(self._h) < 0:
            raise ScannerException(f"encode flush failed: {_err()}")

    def take_packets(self):
        """Returns (data: bytes, sizes, keys, pts, dts) and clears the
        internal queue."""
        n = self._lib.scvid_encoder_pending(self._h)
        if n == 0:
            return b"", np.zeros(0, np.uint64), np.zeros(0, np.uint8), \
                np.zeros(0, np.int64), np.zeros(0, np.int64)
        total = self._lib.scvid_encoder_pending_bytes(self._h)
        data = np.empty(total, np.uint8)
        sizes = np.empty(n, np.uint64)
        keys = np.empty(n, np.uint8)
        pts = np.empty(n, np.int64)
        dts = np.empty(n, np.int64)
        self._lib.scvid_encoder_take(
            self._h, data.ctypes.data_as(C.c_void_p),
            sizes.ctypes.data_as(C.POINTER(C.c_uint64)),
            keys.ctypes.data_as(C.c_void_p),
            pts.ctypes.data_as(C.POINTER(C.c_int64)),
            dts.ctypes.data_as(C.POINTER(C.c_int64)))
        return data.tobytes(), sizes, keys, pts, dts


def _fps_to_rational(fps: float) -> Tuple[int, int]:
    if abs(fps - round(fps)) < 1e-6:
        return int(round(fps)), 1
    # exact small rationals (12.5 -> 25/2) fall out naturally; NTSC rates
    # (29.97...) resolve to their x1001 form (30000/1001) within the bound
    from fractions import Fraction
    frac = Fraction(fps).limit_denominator(100000)
    return frac.numerator, frac.denominator


def write_mp4(path: str, width: int, height: int, fps: float, codec: str,
              extradata: bytes, packets: bytes, sizes: np.ndarray,
              keys: np.ndarray, pts: np.ndarray, dts: np.ndarray,
              tb: Optional[Tuple[int, int]] = None) -> None:
    """tb: (num, den) time base of pts/dts; default = frame numbering at
    `fps` (matches this library's Encoder output)."""
    lib = get_lib()
    fps_num, fps_den = _fps_to_rational(fps)
    tb_num, tb_den = tb if tb is not None else (fps_den, fps_num)
    sizes = np.ascontiguousarray(sizes, np.uint64)
    keys = np.ascontiguousarray(keys, np.uint8)
    pts = np.ascontiguousarray(pts, np.int64)
    dts = np.ascontiguousarray(dts, np.int64)
    r = lib.scvid_mp4_write(
        path.encode(), width, height, fps_num, fps_den, tb_num, tb_den,
        codec.encode(), extradata, len(extradata), packets,
        sizes.ctypes.data_as(C.POINTER(C.c_uint64)),
        keys.ctypes.data_as(C.c_char_p),
        pts.ctypes.data_as(C.POINTER(C.c_int64)),
        dts.ctypes.data_as(C.POINTER(C.c_int64)), len(sizes))
    if r < 0:
        raise ScannerException(f"mp4 write failed: {_err()}")
