"""The plain references against the program at a tiny size on the CPU,
their controls, and the counts of the yardstick."""

import os

import numpy as np

from bench_tiny import REPO
from benchmark.harness import counts, frames, spec

REF = os.path.join(REPO, "benchmark", "reference")
hist_ref = spec.load_module(os.path.join(REF, "histogram.py"), "t_hist_ref")
HIST_CFG = spec.resolve(REPO, "hist.bulk").config
SEED = 2 ** 33 + 17


def tiny_frames(n=8, h=48, w=64, seed=SEED):
    return frames.make_frames(n, h, w, seed, "cpu")


def test_frames_follow_the_pattern():
    from scanner_tpu_torch.video.ingest import frame_pattern
    f = tiny_frames(20).numpy().astype(int)
    noise = f - np.stack([frame_pattern(i, 48, 64) for i in range(20)])
    assert noise.min() == 0 and noise.max() == 15
    assert np.array_equal(tiny_frames(20).numpy(), f.astype(np.uint8))
    assert not np.array_equal(tiny_frames(20, seed=SEED + 1).numpy(), f)


def test_histogram_reference_equals_the_program():
    from scanner_tpu_torch.kernels import cuda_ops
    x = tiny_frames()
    want = cuda_ops.histogram_frames_plain(x, 16).numpy()
    got = hist_ref.reference_counts(HIST_CFG, x.numpy(), "cpu")
    assert np.array_equal(got, want)


def test_histogram_control_is_not_correct():
    x = tiny_frames(4, 96, 128).numpy()
    clips = [(0, 2), (2, 4)]
    low = hist_ref.control_results(HIST_CFG, {}, x, clips, "cpu")
    (value, limit), = hist_ref.compare(HIST_CFG, {}, x, low, "cpu").values()
    assert value > limit
    right = [(c, list(hist_ref.reference_counts(HIST_CFG, x[c[0]:c[1]],
                                                "cpu"))) for c in clips]
    (value, limit), = hist_ref.compare(HIST_CFG, {}, x, right, "cpu").values()
    assert value <= limit


def test_histogram_bytes():
    assert counts.histogram_bytes_per_frame(480, 640, 3, 16) == \
        921600 + 192
