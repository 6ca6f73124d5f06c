"""The histogram kernel's plain version against the JAX package's Pallas
kernel (interpret mode on the CPU) and its numpy flavor, exactly
(tolerance 0: counts are integers).  Geometries follow
tests/test_pallas.py, including sizes that are not multiples of the
Pallas tiles, padding ids, and ragged frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

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


# the frames the JAX op bins that the port's op once refused: int32
# frames (its numpy path and its jnp path) and uint8 frames of five
# channels (more than the kernel's frame entry takes)
QUEUE_C_CASES = {
    "int32_in_range": lambda rng: rng.randint(0, 256, (2, 8, 8, 3))
    .astype(np.int32),
    "uint8_c5": lambda rng: rng.randint(0, 256, (3, 9, 7, 5))
    .astype(np.uint8),
}


@pytest.mark.parametrize("case", sorted(QUEUE_C_CASES))
def test_op_bins_integer_frames_as_jax(case):
    """Histogram.execute on the frames the JAX op bins: its tensor path
    (the kernel's id entry, plain version on the CPU), its numpy path and
    execute_traced all equal the JAX op's counts, exactly."""
    frames = QUEUE_C_CASES[case](np.random.RandomState(11))
    want = np.asarray(JaxHistogram(None).execute(frames))
    k = Histogram(None)
    got_np = k.execute(frames)
    got_t = k.execute(torch.from_numpy(frames))
    assert isinstance(got_np, np.ndarray) and got_np.dtype == np.int32
    assert isinstance(got_t, torch.Tensor) and got_t.dtype == torch.int32
    np.testing.assert_array_equal(got_np, want)
    np.testing.assert_array_equal(got_t.numpy(), want)
    np.testing.assert_array_equal(
        k.execute_traced(torch.from_numpy(frames)).numpy(), want)


def test_op_bins_out_of_range_int32_as_jax_jnp_path():
    """int32 values below 0 and past 255 follow the JAX op's jnp path
    (_histogram_impl): below 0 in bin 0, (v * 16) // 256 >= 16 nowhere."""
    frames = np.random.RandomState(12).randint(-40, 600, (2, 8, 8, 3)) \
        .astype(np.int32)
    want = np.asarray(JaxHistogram(None).execute(jnp.asarray(frames)))
    k = Histogram(None)
    np.testing.assert_array_equal(
        k.execute(torch.from_numpy(frames)).numpy(), want)
    np.testing.assert_array_equal(k.execute(frames), want)


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


# -- the edges the CUDA kernel's design has (csrc/histogram.cu): channel
# counts and bins that pick its private-counter or general instance, flat
# and two-valued frames (every lane on one bin), odd geometries.  The
# plain version is held against the Pallas kernel here; tests/
# test_torch_cuda.py holds the kernel against the plain version.

def _pallas_frames(frames, bins):
    return np.asarray(pallas_ops.histogram_frames(jnp.asarray(frames),
                                                  bins=bins, interpret=True))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("bins", [1, 17, 128])
def test_frames_plain_matches_pallas_channels_bins(channels, bins):
    rng = np.random.RandomState(channels * 1000 + bins)
    frames = rng.randint(0, 256, (2, 13, 11, channels)).astype(np.uint8)
    got = cuda_ops.histogram_frames(torch.from_numpy(frames), bins).numpy()
    assert got.shape == (2, channels, bins)
    np.testing.assert_array_equal(got, _pallas_frames(frames, bins))


@pytest.mark.parametrize("kind,bins", [("flat", 16), ("flat", 17),
                                       ("two_valued", 16),
                                       ("two_valued", 128)])
def test_flat_and_two_valued_frames_match_pallas(kind, bins):
    """Channels flat at 0, 255 and 128, or pixels alternating between 0
    and 255: every count lands in one or two bins."""
    frames = np.empty((3, 9, 14, 3), np.uint8)
    if kind == "flat":
        frames[...] = np.array([0, 255, 128], np.uint8)
    else:
        frames[...] = (np.indices((3, 9, 14)).sum(axis=0) % 2 * 255)[
            ..., None].astype(np.uint8)
    got = cuda_ops.histogram_frames(torch.from_numpy(frames), bins).numpy()
    np.testing.assert_array_equal(got, _pallas_frames(frames, bins))
    assert (got.sum(axis=2) == 9 * 14).all()


@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (3, 1, 17, 4),
                                   (2, 5, 1, 3), (4, 3, 7, 2)])
def test_odd_geometries_match_pallas(shape):
    rng = np.random.RandomState(sum(shape) + 7)
    frames = rng.randint(0, 256, shape).astype(np.uint8)
    got = cuda_ops.histogram_frames(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(got, _pallas_frames(frames, 16))


# -- how the CUDA kernel splits rows among blocks --------------------------

# hist_cluster_caps on an NVIDIA H100 80GB HBM3: how many clusters of
# k = 1..16 one-block-per-SM blocks the card holds at once (its GPCs fit
# 15 clusters of 8 and 7 of 16, not 132 / k)
H100_CAPS = (132, 66, 39, 30, 22, 17, 15, 15, 9, 7, 7, 7, 7, 7, 7, 7)


@pytest.mark.parametrize("rows,k", [
    (16, 6),    # the engine's 16-frame calls: 96 blocks in one wave
    (8, 9),     # its 8-frame tail
    (32, 3),    # the shot path's 32
    (33, 3),
    (1, 16),
    (600, 1),   # more frames than SMs: one block each, in waves
])
def test_blocks_per_row_at_main_path_batches(rows, k):
    assert cuda_ops.blocks_per_row(rows, 480 * 640 * 3, H100_CAPS) == k


@pytest.mark.parametrize("rows,row_bytes,k", [
    (16, 97 * 131 * 3, 2),   # each block keeps MIN_BLOCK_BYTES of a row
    (1, 16384 * 5, 5),
    (3, 1000, 1),
    (16, 0, 1),
])
def test_blocks_per_row_keeps_min_block_bytes(rows, row_bytes, k):
    assert cuda_ops.blocks_per_row(rows, row_bytes, H100_CAPS) == k


def _split_row(addr, n, rank, k):
    """A Python copy of split_row in csrc/histogram.cu (which runs on the
    card) for a uint8 row of n bytes at `addr`: (head, vectors, g0, g1),
    block `rank` of k taking the body's 16-byte vectors [g0, g1).  The
    test below checks the partition and channel phase this copy states;
    the CUDA function itself is held to it by tests/test_torch_cuda.py's
    views at byte offsets 0..15."""
    head = min((16 - addr % 16) % 16, n)
    vectors = (n - head) // 16
    return head, vectors, vectors * rank // k, vectors * (rank + 1) // k


@settings(max_examples=300, deadline=None)
@given(addr=st.integers(0, 4095), pixels=st.integers(0, 400),
       channels=st.integers(1, 4), k=st.integers(1, 16))
def test_row_split_covers_each_byte_once_in_its_channel(addr, pixels,
                                                        channels, k):
    """The private-counter kernel's partition of a uint8 row: block
    `rank` counts body vectors [g0, g1), byte b of vector v in channel
    ((head + 16 v) % C + b) % C (a lane's phase, fixed across its
    steps), and block 0 the head and the tail in channel e % C.  Every
    byte lands in exactly one block, in channel e % C."""
    n = pixels * channels
    seen = np.zeros(n, np.int64)
    chan = np.full(n, -1)
    for rank in range(k):
        head, vectors, g0, g1 = _split_row(addr, n, rank, k)
        assert (addr + head) % 16 == 0 or head == n
        for v in range(g0, g1):
            r = (head + 16 * v) % channels
            for b in range(16):
                e = head + 16 * v + b
                seen[e] += 1
                chan[e] = (r + b % channels) % channels
        if rank == 0:
            for e in list(range(head)) + list(range(head + 16 * vectors,
                                                    n)):
                seen[e] += 1
                chan[e] = e % channels
    assert (seen == 1).all()
    assert (chan == np.arange(n) % channels).all()

