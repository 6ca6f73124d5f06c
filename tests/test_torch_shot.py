"""Shot-detection kernels of the port against the JAX package on the same
numpy inputs: HistDiff (exact — histogram counts are integers, so the
float32 L1 sums are exact) over uint8 frame windows and over any integer
window (Histogram rows, int32 frames) with the JAX package's binning
rules, HistogramDelta, ShotBoundary, detect_shots."""

import numpy as np
import pytest
import torch

from scanner_tpu.kernels import shot as jshot

from scanner_tpu_torch.kernels import shot as tshot


@pytest.mark.parametrize("b,h,w", [(4, 24, 32), (3, 17, 23), (1, 2, 3)])
def test_histdiff_matches_jax(b, h, w):
    rng = np.random.RandomState(b * h * w)
    win = rng.randint(0, 256, (b, 2, h, w, 3)).astype(np.uint8)
    want = np.asarray(jshot.HistDiff(None).execute_traced(win))
    got_t = tshot.HistDiff(None).execute_traced(torch.from_numpy(win))
    assert got_t.dtype == torch.float32
    np.testing.assert_array_equal(got_t.numpy(), want)
    # execute(): numpy batch and per-row window lists give python floats
    jk, tk = jshot.HistDiff(None), tshot.HistDiff(None)
    assert tk.execute(win) == jk.execute(win)
    rows = [[win[i, 0], win[i, 1]] for i in range(b)]
    assert tk.execute(rows) == jk.execute(rows)


@pytest.mark.parametrize("shape,dtype", [
    ((5, 2, 3, 16), np.int32),        # Histogram rows: the golden chain
    ((4, 2, 9, 11, 3), np.int32),     # int32 frames
    ((3, 2, 9, 11, 3), np.uint8),     # uint8 frames, numpy and tensor
    ((2, 2, 5, 7, 6), np.uint8),      # more channels than the kernel takes
    ((4, 2, 3), np.int64),            # one value per channel
])
def test_histdiff_any_integer_window_matches_jax(shape, dtype):
    """The JAX package bins every window member by (v * 16) // 256 over
    its trailing (channel) axis: negatives count in bin 0 and values from
    256 on count nowhere.  Integer windows here straddle both edges, so
    the clip and the drop both show; the port's numpy path and its
    tensor path (the plain versions of the kernel's id and frame
    entries) must give the same distances, and so must execute()."""
    rng = np.random.RandomState(sum(shape))
    lo, hi = (0, 256) if dtype == np.uint8 else (-40, 300)
    win = rng.randint(lo, hi, shape).astype(dtype)
    if dtype == np.int32 and len(shape) == 4:
        # rows of counts: mostly small, some past 256 and below 0
        win = rng.choice([-3, 0, 1, 15, 16, 17, 200, 255, 256, 4000],
                         shape).astype(dtype)
    assert (win < 0).any() or dtype == np.uint8
    want = np.asarray(jshot.HistDiff(None).execute_traced(win))
    tk = tshot.HistDiff(None)
    np.testing.assert_array_equal(tk.execute_traced(win).numpy(), want)
    np.testing.assert_array_equal(
        tk.execute_traced(torch.from_numpy(win)).numpy(), want)
    assert tk.execute(win) == jshot.HistDiff(None).execute(win)
    assert tk.execute(torch.from_numpy(win)) == [float(x) for x in want]


def test_histogram_delta_and_boundary_match_jax():
    rng = np.random.RandomState(5)
    hists = [[rng.randint(0, 999, 16).astype(np.int32) for _ in range(3)]
             for _ in range(2)]
    assert tshot.HistogramDelta(None).execute(hists) == \
        jshot.HistogramDelta(None).execute(hists)
    for thr, diff in [(0.0, 0.0), (10.0, 10.5), (10.0, 9.5)]:
        tk, jk = tshot.ShotBoundary(None), jshot.ShotBoundary(None)
        tk.new_stream(threshold=thr)
        jk.new_stream(threshold=thr)
        assert tk.execute(diff) == jk.execute(diff)


def test_detect_shots_matches_jax():
    rng = np.random.RandomState(11)
    diffs = rng.exponential(1.0, 300)
    diffs[[20, 24, 90, 200, 203, 260]] += 40.0
    for z, gap in [(2.5, 8), (1.0, 3), (4.0, 1)]:
        np.testing.assert_array_equal(tshot.detect_shots(diffs, z, gap),
                                      jshot.detect_shots(diffs, z, gap))
