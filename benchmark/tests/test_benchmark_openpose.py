"""The `pose.bulk` cell: its files found by name, its FLOP count, its
plain reference against the program's own reference copy, and its
comparison going false where a stored answer is altered; on the CPU at
narrow widths (every layer and stage kept) and tiny frames."""

import json
import os

import numpy as np
import pytest
import torch

from bench_tiny import REPO, run_tiny, tiny_root
from benchmark.harness import frames, openpose_flops, spec

REF = os.path.join(REPO, "benchmark", "reference", "openpose.py")
bench_ref = spec.load_module(REF, "t_openpose_ref")
tests_ref = spec.load_module(os.path.join(REPO, "tests",
                                          "torch_openpose_ref.py"),
                             "t_tests_openpose_ref")
NARROW = dict(conv1=4, conv2=8, conv3=16, conv4=32, cpm=16, features=8,
              stage1=8, stage1_hidden=32, stage=8)
SEED = 2 ** 33 + 23


def narrow_config():
    cfg = json.loads(json.dumps(spec.resolve(REPO, "pose.bulk").config))
    cfg["net"]["widths"] = dict(NARROW)
    return cfg


def tiny(n=3, seed=SEED):
    return frames.make_frames(n, 48, 64, seed, "cpu").numpy()


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    return bench_ref.prepare(narrow_config(), SEED, "cpu",
                             str(tmp_path_factory.mktemp("pose")))


def test_pose_cell_resolves():
    cell = spec.resolve(REPO, "pose.bulk")
    assert spec.contract_errors(spec.load_doc(REPO)) == []
    assert cell.chips == 1
    assert cell.config["ops"] == [{"op": "OpenPose", "args": {
        "checkpoint_dir": "{weights}"}}]
    assert cell.traffic["frames_per_job"] == 128
    assert cell.generator.clips(cell.traffic, 600) == [
        (0, 128), (128, 256), (256, 384), (384, 512)]
    assert {m["name"] for m in cell.per_layer} == {
        "eval_ms_per_frame.openpose", "openpose_net_ms_per_frame",
        "openpose_post_ms_per_frame", "openpose_mfu"}
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s",
                                                    "setup_s"}
    for fn in ("prepare", "compare", "control_results"):
        assert callable(getattr(cell.reference, fn))


def test_flops_from_the_configuration():
    cfg = spec.resolve(REPO, "pose.bulk").config
    assert openpose_flops.config_flops_per_frame(cfg) == 366_430_800_896
    assert openpose_flops.peak("NVIDIA H100 80GB HBM3") == 989.4e12
    assert openpose_flops.peak("cpu") is None
    # by hand: every width 1, two stages, a 16 x 16 input.  Front:
    # conv1_1 2*3*9*256, conv1_2 2*9*256, conv2_* 2 * 2*9*64, conv3_*
    # 4 * 2*9*16, conv4_* and CPM 4 * 2*9*4; stage 1 (4 pixels): 3 * 72
    # + 8 + 8 C per branch; stage 2: Mconv1 2*58*49*4, Mconv2-5
    # 4 * 2*49*4, Mconv6 8, Mconv7 8 C
    ones = {k: 1 for k in NARROW}
    want = (13824 + 4608 + 2 * 1152 + 4 * 288 + 4 * 72
            + 2 * (3 * 72 + 8) + 8 * 38 + 8 * 19
            + 2 * (22736 + 4 * 392 + 8) + 8 * 38 + 8 * 19)
    assert want == 72160
    assert openpose_flops.flops_per_frame(16, 16, ones, 2) == want
    from scanner_tpu_torch.models import openpose as op
    assert op.net_flops(16, 16, dict(ones, stages=2)) == want
    assert op.net_flops(368, 496) == 366_430_800_896


def test_mfu_reads_the_network_kernels_device_time():
    """openpose_mfu divides by the device time of the network's kernels
    (convolutions and the bf16 kernels around them), not by the slice's
    wall or by the float32 post-processing's kernels."""
    from types import SimpleNamespace
    from benchmark.harness.trace import DeviceTrace
    mfu = spec.load_module(os.path.join(REPO, "benchmark", "metrics",
                                        "openpose_mfu.py"), "t_op_mfu")
    cell = spec.resolve(REPO, "pose.bulk")
    kind = next(iter(openpose_flops.PEAK_BF16_FLOPS))
    events = [
        (0.0, 0.3, "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32"),
        (0.3, 0.4, "void at::native::elementwise_kernel<128, 4, "
                   "CUDAFunctor_add<c10::BFloat16> >"),
        (0.4, 0.9, "void at::native::upsample_bicubic2d_out_frame"
                   "<float, float>"),
    ]

    def rec(evs, frames_=64):
        return SimpleNamespace(
            device_kind=kind, config=cell.config,
            trace=DeviceTrace(0.0, 10.0, evs),
            traced_jobs=[SimpleNamespace(frames=frames_)])

    want = 100.0 * 64 * openpose_flops.config_flops_per_frame(
        cell.config) / (openpose_flops.peak(kind) * 0.4)
    assert mfu.read(rec(events)) == pytest.approx(want)
    assert mfu.read(rec(events[2:])) is None
    assert mfu.read(rec(events, 0)) is None
    assert mfu.read(SimpleNamespace(device_kind="cpu", config=cell.config,
                                    trace=None, traced_jobs=[])) is None


def test_reference_copy_agrees_with_the_tests_reference():
    wa = bench_ref.init_weights(SEED, NARROW)
    wb = tests_ref.init_weights(SEED, NARROW)
    assert wa.keys() == wb.keys()
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    x = torch.from_numpy(tiny(2))
    np.testing.assert_array_equal(bench_ref.rows(wa, x),
                                  tests_ref.rows(wb, x))


def _right(prepared, x, clips):
    w = bench_ref.load(prepared, "cpu")
    rows = bench_ref.rows(w, torch.from_numpy(x))
    return [(c, [r.copy() for r in rows[c[0]:c[1]]]) for c in clips]


def _checks(prepared, x, results):
    return bench_ref.compare(narrow_config(), prepared, x, results, "cpu")


def _valid_peak(row):
    pk = row[:bench_ref.PARTS * bench_ref.K * 4].reshape(18, 16, 4)
    p, i = np.argwhere(pk[..., 3] > 0.5)[0]
    return p, i


def test_compare_judges_altered_rows(prepared):
    x = tiny(3)
    clips = [(0, 2), (1, 3)]
    good = _right(prepared, x, clips)
    assert all(v <= lim for v, lim in _checks(prepared, x, good).values())

    def altered(change):
        res = [(c, [r.copy() for r in rows]) for c, rows in good]
        change(res[1][1])
        return _checks(prepared, x, res)

    def bump_score(rows):
        p, i = _valid_peak(rows[0])
        rows[0][(p * 16 + i) * 4 + 2] += 0.3

    def bump_pair(rows):
        pairs = rows[0][bench_ref.PARTS * 16 * 4:].reshape(19, 16, 16)
        li, i, j = np.argwhere(pairs != 0)[0]
        pairs[li, i, j] += 0.5

    def move_peak(rows):
        # the best peak of a part, moved 40 pixels down with its score
        p, i = _valid_peak(rows[0])
        rows[0][(p * 16 + i) * 4 + 1] += 40 * 48 / 368

    def drop_part(rows):
        # a part's peaks no longer stored: the reference's go missing
        p, _ = _valid_peak(rows[0])
        rows[0][p * 64:(p + 1) * 64] = 0

    def drop_row(rows):
        rows.pop()

    for change, name in ((bump_score, "pose_score_err"),
                         (bump_pair, "pose_pair_err"),
                         (move_peak, "pose_score_err"),
                         (drop_part, "pose_peaks_wrong"),
                         (drop_row, "pose_peaks_wrong")):
        value, limit = altered(change)[name]
        assert value > limit, change.__name__


def test_control_is_not_correct(tmp_path):
    """The float8 control at a quarter of the published widths (at
    NARROW's sixteenth its errors stay inside the cell's limits: fewer
    and smaller terms in each sum)."""
    cfg = narrow_config()
    cfg["net"]["widths"] = {k: v // 4 for k, v in
                            spec.resolve(REPO, "pose.bulk").config["net"]
                            ["widths"].items()}
    prepared = bench_ref.prepare(cfg, SEED, "cpu", str(tmp_path))
    x = tiny(2)
    low = bench_ref.control_results(cfg, prepared, x, [(0, 2)], "cpu")
    checks = bench_ref.compare(cfg, prepared, x, low, "cpu")
    assert any(v > lim for v, lim in checks.values()), checks


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    dest = tiny_root(str(tmp_path_factory.mktemp("bench_pose")))
    path = os.path.join(dest, "benchmark", "configs",
                        "openpose_coco_640x480.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["net"]["widths"] = dict(NARROW)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return dest


def test_tiny_run_is_correct_and_traced(root, capsys):
    rc, out = run_tiny(root, "pose.bulk", capsys, trace=1)
    assert rc == 0 and out["correct"] and out["failed"] == 0, out
    assert set(out["checks"]) == {"pose_score_err", "pose_pair_err",
                                  "pose_peaks_wrong"}
    for m in ("eval_ms_per_frame.openpose", "openpose_net_ms_per_frame",
              "openpose_post_ms_per_frame"):
        assert out["metrics"][m]["value"] > 0
    # no listed peak for the CPU
    assert "openpose_mfu" not in out["metrics"]


def test_altered_peak_is_not_correct(root, capsys, monkeypatch):
    from scanner_tpu_torch.models import openpose as op
    sound = op.OpenPose.execute

    def broken(self, *args, **kw):
        out = np.array(sound(self, *args, **kw))
        out[:, 2] += 0.3          # the first part's best peak score
        return out

    monkeypatch.setattr(op.OpenPose, "execute", broken)
    rc, out = run_tiny(root, "pose.bulk", capsys)
    assert rc == 0 and out is not None
    assert out["correct"] is False, out
