"""The image stdlib (Resize, CropResize, Blur, OpticalFlow, Grayscale,
ImageEncode, ImageDecode): the port against the JAX package on the CPU,
on the same seeded numpy frames, and the golden Resize -> Blur ->
Histogram -> HistDiff chain through Client(device="cpu").

Tolerances:
  * Resize and CropResize: within 1 uint8 count (the float32 tap sums
    round to the same integer but for sums that land within an ulp of a
    half, where XLA's fused multiply-adds and torch's separate products
    round apart); Blur bit for bit (the same taps summed in the same
    order);
  * OpticalFlow: atol 1e-4 on flows of a few pixels (the 3x3 average is
    a conv in JAX and a shift-add here, summed in another order, through
    16 iterations);
  * Grayscale, the codecs, the histogram rows and HistDiff: equal.
"""

import io
from typing import Sequence

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanner_tpu.common import DeviceType
from scanner_tpu.graph.ops import KernelConfig as JConfig
from scanner_tpu.kernels import image as jimage
from scanner_tpu.kernels import imgproc as jimg
from scanner_tpu.kernels import shot as jshot

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.engine.executor import LocalExecutor
from scanner_tpu_torch.graph.ops import Kernel, register_op
from scanner_tpu_torch.graph.ops import KernelConfig as TConfig
from scanner_tpu_torch.kernels import cuda_ops
from scanner_tpu_torch.kernels import image as timage
from scanner_tpu_torch.kernels import imgproc as timg
from scanner_tpu_torch.util.profiler import Profiler
from torch_model_checks import stop_process_engine  # noqa: F401

CPU_J, CPU_T = JConfig(device=DeviceType.CPU), TConfig(device=DeviceType.CPU)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _frames(n, h, w, seed):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, 3)) \
        .astype(np.uint8)


def _within_one(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert d.max() <= 1, d.max()
    return float((d > 0).mean())


@pytest.mark.parametrize("h,w", [(24, 32), (48, 64), (17, 29), (96, 100),
                                 (31, 80)])
def test_resize_matches_jax(h, w):
    f = _frames(3, 48, 64, h * w)
    want = np.asarray(jimg._resize_impl(jnp.asarray(f), h, w))
    k = timg.Resize(CPU_T)
    k.new_stream(width=w, height=h)
    got = k.execute(f)
    assert _within_one(got, want) < 0.01
    np.testing.assert_array_equal(
        timg.resize(torch.from_numpy(f), h, w).numpy(), got)


@pytest.mark.parametrize("oh,ow", [(32, 32), (16, 24), (64, 48)])
def test_crop_resize_matches_jax(oh, ow):
    """Boxes larger than the output (antialiased: the triangle widens),
    smaller (upsampled), under one pixel, the whole frame, and partly
    past the frame's edge (outputs whose sample falls outside get 0)."""
    f = _frames(6, 48, 64, oh * ow)
    boxes = np.asarray([[0.0, 0.0, 0.5, 0.5], [0.1, 0.2, 0.9, 0.7],
                        [0.3, 0.3, 0.35, 0.4], [0.5, 0.5, 0.5, 0.5],
                        [0.0, 0.0, 1.0, 1.0], [-0.2, 0.6, 0.5, 1.3]],
                       np.float32)
    want = np.asarray(jimg._crop_resize_impl(jnp.asarray(f),
                                             jnp.asarray(boxes), oh, ow))
    k = timg.CropResize(CPU_T, height=oh, width=ow)
    got = k.execute(f, list(boxes))
    assert _within_one(got, want) < 0.01
    np.testing.assert_array_equal(
        k.execute(torch.from_numpy(f), torch.from_numpy(boxes)).numpy(), got)


@pytest.mark.parametrize("ksize,sigma", [(3, 0.5), (3, 1.1), (4, 2.0),
                                         (7, 3.0)])
def test_blur_matches_jax_bit_exact(ksize, sigma):
    f = _frames(2, 37, 53, ksize)
    want = np.asarray(jimg.Blur(CPU_J, kernel_size=ksize,
                                sigma=sigma).execute(f))
    tk = timg.Blur(CPU_T, kernel_size=ksize, sigma=sigma)
    np.testing.assert_array_equal(tk.execute(f), want)
    np.testing.assert_array_equal(tk.execute(torch.from_numpy(f)).numpy(),
                                  want)


def test_optical_flow_matches_jax():
    rng = np.random.RandomState(9)
    base = rng.randint(0, 256, (3, 40, 56, 3)).astype(np.uint8)
    win = np.stack([base, np.roll(base, (1, 2), axis=(1, 2))], axis=1)
    want = np.asarray(jimg.OpticalFlow(CPU_J).execute(win))
    tk = timg.OpticalFlow(CPU_T)
    got = tk.execute(win)
    assert got.shape == (3, 40, 56, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    rows = [[w[0], w[1]] for w in win]
    np.testing.assert_array_equal(tk.execute(rows), got)
    np.testing.assert_array_equal(
        tk.execute(torch.from_numpy(win)).numpy(), got)
    g = timg._grayscale(torch.from_numpy(base)).numpy()
    np.testing.assert_allclose(g, np.asarray(jimg._grayscale(
        jnp.asarray(base))), rtol=1e-6, atol=1e-4)


def test_grayscale_and_codecs_match_jax():
    f = _frames(1, 24, 32, 3)[0]
    np.testing.assert_array_equal(timage.Grayscale(CPU_T).execute(f),
                                  jimage.Grayscale(CPU_J).execute(f))
    for fmt in ("png", "jpeg"):
        got = timage.ImageEncode(CPU_T, format=fmt).execute(f)
        assert got == jimage.ImageEncode(CPU_J, format=fmt).execute(f)
        np.testing.assert_array_equal(timage.ImageDecode(CPU_T).execute(got),
                                      jimage.ImageDecode(CPU_J).execute(got))
    png = timage.ImageEncode(CPU_T).execute(f)
    from PIL import Image
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png))), f)


@register_op(name="TorchTestQuadBox")
def _quad_box(config, ignore: st.FrameType) -> object:
    return np.asarray([0.0, 0.0, 0.5, 0.5], np.float32)   # TL quadrant


@register_op(name="TorchTestFrameRows", device=st.DeviceType.TPU, batch=16)
class _FrameRows(Kernel):
    """Frames passed on as a pickled column: the sink stores them as they
    are, where a frame column would go through the lossy H.264 encoder."""

    def execute(self, frame: Sequence[st.FrameType]) -> Sequence[object]:
        return frame


def test_crop_resize_two_input_op_through_client(tmp_path):
    """CropResize consumes a frame column AND a per-row box column
    through the batched data path; the crops land where the boxes say
    (tests/test_engine.py's check: within a mean of 3 counts of a resize
    of the quadrant)."""
    f = _frames(6, 48, 64, 17)
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    try:
        sc.new_table("frames", ["frame"], [[x] for x in f],
                     codecs={"frame": "pickle"})
        src = sc.io.Input([st.NamedStream(sc, "frames")])
        crops = sc.ops.TorchTestFrameRows(frame=sc.ops.CropResize(
            frame=src, box=sc.ops.TorchTestQuadBox(ignore=src), size=32))
        sc.run(sc.io.Output(crops, [st.NamedStream(sc, "crops")]),
               st.PerfParams.manual(4, 8), show_progress=False)
        rows = list(st.NamedStream(sc, "crops").load())
    finally:
        sc.stop()
    assert len(rows) == 6 and rows[0].shape == (32, 32, 3)
    quad = np.asarray([[0.0, 0.0, 0.5, 0.5]] * 6, np.float32)
    np.testing.assert_array_equal(
        np.stack(rows), timg.crop_resize(torch.from_numpy(f),
                                         torch.from_numpy(quad), 32,
                                         32).numpy())
    expect = np.asarray(jimg._resize_impl(jnp.asarray(f[:1, :24, :32]),
                                          32, 32))[0]
    assert np.abs(rows[0].astype(int) - expect.astype(int)).mean() < 3.0


def _golden(sc, table, out_prefix, ex=None):
    """Resize(W/2, H/2) -> Blur(3, 1.1), stored; + Histogram; +
    HistDiff; each through `sc` (or the executor `ex`)."""
    src = sc.io.Input([st.NamedStream(sc, table)])
    small = sc.ops.Blur(frame=sc.ops.Resize(frame=src, width=[32],
                                            height=[24]),
                        kernel_size=3, sigma=1.1)
    hist = sc.ops.Histogram(frame=small)
    diff = sc.ops.HistDiff(frame=hist)
    outs = [sc.io.Output(col, [st.NamedStream(sc, f"{out_prefix}_{n}")])
            for col, n in ((sc.ops.TorchTestFrameRows(frame=small),
                            "frames"), (hist, "hist"),
                           (diff, "diff"))]
    for o in outs:
        if ex is None:
            sc.run(o, st.PerfParams.manual(8, 16), show_progress=False,
                   cache_mode=st.CacheMode.Overwrite)
        else:
            ex.run([o], st.PerfParams.manual(8, 16))
    return [list(st.NamedStream(sc, f"{out_prefix}_{n}").load())
            for n in ("frames", "hist", "diff")]


def test_golden_chain_through_client(tmp_path):
    """The bench's chain: the frames within one count of the JAX
    package's Resize -> Blur; every Histogram row the plain histogram of
    the run's own frame; every HistDiff row what the JAX package's
    HistDiff computes over the stored (3, 16) rows.  The staged tensor
    path (the card's, on CPU tensors, through the kernel wrappers' plain
    versions) stores the same rows."""
    f = _frames(20, 48, 64, 23)
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    try:
        sc.new_table("frames", ["frame"], [[x] for x in f],
                     codecs={"frame": "pickle"})
        frames, hist, diff = _golden(sc, "frames", "g")
        ex = LocalExecutor(sc._db, Profiler(), torch.device("cpu"),
                           stage=True)
        staged = _golden(sc, "frames", "gs", ex)
    finally:
        sc.stop()
    frames = np.stack(frames)
    want = np.asarray(jimg.Blur(CPU_J, kernel_size=3, sigma=1.1).execute(
        jimg._resize_impl(jnp.asarray(f), 24, 32)))
    _within_one(frames, want)
    hist = np.stack(hist)
    np.testing.assert_array_equal(
        hist, cuda_ops.histogram_frames_plain(torch.from_numpy(frames))
        .numpy())
    win = np.stack([hist[np.maximum(np.arange(20) - 1, 0)], hist], axis=1)
    assert diff == jshot.HistDiff(None).execute(win)
    assert np.array_equal(np.stack(staged[0]), frames)
    assert np.array_equal(np.stack(staged[1]), hist)
    assert staged[2] == diff
