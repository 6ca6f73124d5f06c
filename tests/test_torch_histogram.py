"""The histogram kernel's plain version against the JAX package's Pallas
kernel (interpret mode on the CPU) and its numpy flavor, exactly
(tolerance 0: counts are integers).  Geometries follow
tests/test_pallas.py, including sizes that are not multiples of the
Pallas tiles, padding ids, and ragged frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanner_tpu.kernels import pallas_ops
from scanner_tpu.kernels.imgproc import Histogram as JaxHistogram

from scanner_tpu_torch.kernels import cuda_ops
from scanner_tpu_torch.kernels.imgproc import Histogram, histogram_np


@pytest.mark.parametrize("rows,pix,bins,lo,hi", [
    (5, 1000, 16, 0, 16),       # test_pallas: vs numpy
    (3, 7, 4, 2, 3),            # test_pallas: padding must not leak
    (9, 333, 16, -3, 20),       # ids outside [0, bins) count nowhere
    (2, 50, 128, 0, 129),       # bins == LANES, padding id == bins
])
def test_ids_plain_matches_pallas(rows, pix, bins, lo, hi):
    rng = np.random.RandomState(rows * pix)
    vals = rng.randint(lo, hi, (rows, pix)).astype(np.int32)
    # the Pallas kernel's compare+reduce counts exactly the ids in
    # [0, bins), negative ones included in "nowhere"
    want = np.asarray(pallas_ops.pallas_histogram(
        jnp.asarray(vals), bins=bins, interpret=True))
    got = cuda_ops.histogram_ids(torch.from_numpy(vals), bins).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [
    (3, 48, 64, 3),     # test_pallas
    (5, 33, 41, 3),     # ragged H, W
    (2, 97, 131, 3),    # odd geometry
    (1, 1, 1, 3),
    (2, 7, 5, 1),       # one channel
])
def test_frames_plain_matches_pallas_and_numpy(shape):
    rng = np.random.RandomState(sum(shape))
    frames = rng.randint(0, 256, shape).astype(np.uint8)
    want = np.asarray(pallas_ops.histogram_frames(
        jnp.asarray(frames), interpret=True))
    got = cuda_ops.histogram_frames(torch.from_numpy(frames)).numpy()
    assert got.dtype == np.int32 and got.shape == (shape[0], shape[-1], 16)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(histogram_np(frames), want)
    np.testing.assert_array_equal(JaxHistogram._histogram_np(frames), want)


def test_flat_frames_all_in_one_bin():
    """The skewed case (every pixel of a channel in one bin)."""
    frames = np.full((2, 9, 11, 3), 200, np.uint8)
    got = cuda_ops.histogram_frames(torch.from_numpy(frames)).numpy()
    want = np.asarray(pallas_ops.histogram_frames(jnp.asarray(frames),
                                                  interpret=True))
    np.testing.assert_array_equal(got, want)
    assert (got[:, :, 200 * 16 // 256] == 99).all()


def test_op_execute_on_tensor_and_array():
    """Histogram.execute: numpy frames take the numpy flavor, CPU tensors
    the kernel wrapper's plain version; both agree."""
    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, (4, 12, 10, 3)).astype(np.uint8)
    k = Histogram(None)
    a = k.execute(frames)
    b = k.execute(torch.from_numpy(frames))
    assert isinstance(a, np.ndarray) and isinstance(b, torch.Tensor)
    np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("bad,err", [
    (lambda: torch.zeros((2, 4, 4, 3), dtype=torch.int32), TypeError),
    (lambda: torch.zeros((4, 4, 3), dtype=torch.uint8), ValueError),
])
def test_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        cuda_ops.histogram_frames(bad())


def test_wrapper_rejects_bad_bins():
    with pytest.raises(ValueError):
        cuda_ops.histogram_ids(torch.zeros((2, 3), dtype=torch.int32), 129)


def test_plain_launch_counts_nothing():
    """The launch counter moves only where the CUDA kernel launches."""
    before = cuda_ops.histogram_launches
    cuda_ops.histogram_frames(torch.zeros((1, 4, 4, 3), dtype=torch.uint8))
    assert cuda_ops.histogram_launches == before
