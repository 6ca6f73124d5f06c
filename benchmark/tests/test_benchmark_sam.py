"""The `sam.bulk` cell: its files found by name, its FLOP counts, its
readers on synthetic traces and spans, its plain reference against the
program's own reference copy, and its comparison going false where a
stored answer is altered; on the CPU at a small size (every kind of
block kept) and tiny frames."""

import inspect
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bench_tiny import REPO, run_tiny, tiny_root
from benchmark.harness import frames, sam_flops, spec
from benchmark.harness.trace import DeviceTrace

REF = os.path.join(REPO, "benchmark", "reference", "sam.py")
bench_ref = spec.load_module(REF, "t_sam_ref")
tests_ref = spec.load_module(os.path.join(REPO, "tests", "torch_sam_ref.py"),
                             "t_tests_sam_ref")
SMALL = dict(img_size=160, patch=16, width=64, depth=4, heads=2, mlp=256,
             window=4, global_blocks=[1, 3], out=32)
SEED = 2 ** 33 + 31


def metric(name):
    return spec.load_module(os.path.join(REPO, "benchmark", "metrics",
                                         name + ".py"), "t_" + name)


def small_config():
    cfg = json.loads(json.dumps(spec.resolve(REPO, "sam.bulk").config))
    cfg["net"].update(SMALL)
    return cfg


def tiny(n=3, seed=SEED):
    return frames.make_frames(n, 48, 64, seed, "cpu").numpy()


@pytest.fixture(scope="module")
def prepared(tmp_path_factory):
    return bench_ref.prepare(small_config(), SEED, "cpu",
                             str(tmp_path_factory.mktemp("sam")))


def test_sam_cell_resolves():
    cell = spec.resolve(REPO, "sam.bulk")
    assert spec.contract_errors(spec.load_doc(REPO)) == []
    assert cell.chips == 1
    assert cell.config["ops"] == [{"op": "SamEmbed", "args": {
        "checkpoint_dir": "{weights}"}}]
    assert (cell.traffic["frames_per_job"], cell.traffic["work_packet_size"],
            cell.traffic["io_packet_size"]) == (64, 8, 32)
    assert cell.generator.clips(cell.traffic, 256) == [
        (0, 64), (64, 128), (128, 192), (192, 256)]
    assert {m["name"] for m in cell.per_layer} == {
        "eval_ms_per_frame.sam", "sam_net_ms_per_frame", "sam_mfu",
        "sam_attn_roofline", "save_ms_per_frame.sam"}
    assert {m["name"] for m in cell.end_to_end} == {"frames_per_s",
                                                    "setup_s"}
    for fn in ("prepare", "compare", "control_results"):
        assert callable(getattr(cell.reference, fn))
    assert bench_ref.config_arch(cell.config) == bench_ref.PUBLISHED


def test_flops_from_the_configuration():
    cfg = spec.resolve(REPO, "sam.bulk").config
    assert sam_flops.config_flops(cfg) == (5_961_082_830_848,
                                           481_280_327_680)
    assert round(sam_flops.config_flops(cfg)[0] / 1e9, 2) == \
        cfg["gflop_per_frame"]
    assert sam_flops.peak("NVIDIA H100 80GB HBM3") == 989.4e12
    assert sam_flops.peak("cpu") is None
    # by hand: width 2, 1 head, mlp 4, out 1, a 4 x 4 grid of 1-pixel
    # patches, window 3 (padded to 6: 4 windows of 9), block 1 global.
    # Patch 2*16*2*3, neck 2*16*(2 + 9); block 0: qkv/proj 2*36*4*4, MLP
    # 2*16*2*2*4, tables 2*36*2*2*3, products 2*2*4*81*2; block 1:
    # 2*16*4*4, the same MLP, 2*16*2*2*4, 2*2*256*2
    net = dict(img_size=4, patch=1, width=2, depth=2, heads=1, mlp=4,
               window=3, global_blocks=[1], out=1)
    want = (192 + 352 + 1152 + 512 + 864 + 2592
            + 512 + 512 + 512 + 2048)
    assert want == 9248
    assert sam_flops.flops_per_frame(net) == want
    assert sam_flops.attention_flops_per_frame(net) == 2592 + 2048
    from scanner_tpu_torch.models import sam as op
    assert op.encoder_flops(net) == want
    assert op.encoder_flops() == 5_961_082_830_848


def _rec(events, frames_=64, kind=None, cfg=None):
    return SimpleNamespace(
        device_kind=kind or next(iter(sam_flops.openpose_flops
                                      .PEAK_BF16_FLOPS)),
        config=cfg or spec.resolve(REPO, "sam.bulk").config,
        trace=DeviceTrace(0.0, 10.0, events),
        traced_jobs=[SimpleNamespace(frames=frames_)])


def test_mfu_and_attention_roofline_read_the_device_time():
    """sam_mfu divides by every kernel's device time (copies and
    memsets left out), sam_attn_roofline by the attention kernels'
    alone, found by name."""
    mfu, roof = metric("sam_mfu"), metric("sam_attn_roofline")
    events = [
        (0.0, 0.5, "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize"),
        (0.5, 0.7, "fmha_cutlassF_bf16_aligned_64x64_rf_sm80("
                   "PyTorchMemEffAttention::AttentionKernel)"),
        (0.7, 0.8, "cudnn_generated_fort_native_sdpa_sm90_FLASH_fprop"),
        (0.8, 0.9, "void at::native::vectorized_elementwise_kernel"),
        (0.9, 2.0, "Memcpy DtoH (Device -> Pinned)"),
        (2.0, 2.5, "Memset (Device)"),
    ]
    kind = next(iter(sam_flops.openpose_flops.PEAK_BF16_FLOPS))
    peak = sam_flops.peak(kind)
    cfg = spec.resolve(REPO, "sam.bulk").config
    total, attn = sam_flops.config_flops(cfg)
    assert mfu.read(_rec(events)) == pytest.approx(
        100.0 * 64 * total / (peak * 0.9))
    assert roof.read(_rec(events)) == pytest.approx(
        100.0 * 64 * attn / (peak * 0.3))
    assert roof.read(_rec(events[:1] + events[3:])) is None
    assert mfu.read(_rec(events[4:])) is None
    for m in (mfu, roof):
        assert m.read(_rec(events, 0)) is None
        assert m.read(_rec(events, kind="cpu")) is None
        assert m.read(SimpleNamespace(device_kind=kind, config=cfg,
                                      trace=None, traced_jobs=[])) is None


def test_span_readers():
    """eval_ms_per_frame.sam, sam_net_ms_per_frame and
    save_ms_per_frame.sam: their spans' seconds over the frames of every
    job, nothing where no job recorded them."""
    def job(stats, n=64):
        return SimpleNamespace(stats=stats, frames=n)

    def total(s):
        return {"count": 1, "total_s": s, "mean_s": s}

    jobs = [job({"evaluate:SamEmbed": total(1.0), "sam:net": total(0.8),
                 "save:fetch": total(0.1), "save:write": total(0.3)}),
            job({"evaluate:SamEmbed": total(0.6), "save:write": total(0.2)})]
    rec = SimpleNamespace(jobs=jobs, frames=128)
    assert metric("eval_ms_per_frame.sam").read(rec) == pytest.approx(
        1e3 * 1.6 / 128)
    assert metric("sam_net_ms_per_frame").read(rec) == pytest.approx(
        1e3 * 0.8 / 128)
    assert metric("save_ms_per_frame.sam").read(rec) == pytest.approx(
        1e3 * 0.6 / 128)
    empty = SimpleNamespace(jobs=[job({"load": total(1.0)})], frames=64)
    for name in ("eval_ms_per_frame.sam", "sam_net_ms_per_frame",
                 "save_ms_per_frame.sam"):
        assert metric(name).read(empty) is None


def test_reference_copy_agrees_with_the_tests_reference():
    """The network's functions are the same source in both copies, and
    give the same embeddings."""
    names = [n for n, f in vars(tests_ref).items()
             if inspect.isfunction(f) and f.__module__ == tests_ref.__name__]
    assert {"prep", "encoder", "block", "attention", "init_weights",
            "embed", "window_partition"} <= set(names)
    for n in names:
        assert inspect.getsource(getattr(bench_ref, n)) == \
            inspect.getsource(getattr(tests_ref, n)), n
    for k in ("PIXEL_MEAN", "PIXEL_STD", "EPS", "PUBLISHED", "CONTROLS",
              "QKV_GAIN", "QKV_BIAS_STD", "BIAS_STD", "NORM_STD",
              "POS_STD"):
        assert getattr(bench_ref, k) == getattr(tests_ref, k), k
    wa = bench_ref.init_weights(SEED, SMALL)
    wb = tests_ref.init_weights(SEED, SMALL)
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    x = torch.from_numpy(tiny(2))
    assert torch.equal(bench_ref.embed(wa, x), tests_ref.embed(wb, x))


def test_weights_file_holds_the_bf16_bits(prepared):
    w = bench_ref.load(prepared, "cpu")
    want = bench_ref.init_weights(SEED, SMALL)
    assert w.keys() == want.keys()
    assert all(torch.equal(w[k], want[k]) for k in w)


def _right(prepared, x, clips):
    w = bench_ref.load(prepared, "cpu")
    rows = bench_ref.embed(w, torch.from_numpy(x)).half().numpy()
    return [(c, [r.copy() for r in rows[c[0]:c[1]]]) for c in clips]


def _checks(prepared, x, results):
    return bench_ref.compare(small_config(), prepared, x, results, "cpu")


def test_compare_judges_altered_rows(prepared):
    x = tiny(3)
    clips = [(0, 2), (1, 3)]
    good = _right(prepared, x, clips)
    checks = _checks(prepared, x, good)
    assert set(checks) == {"sam_embed_err", "sam_edge_err",
                           "sam_rows_missing"}
    assert all(v <= lim for v, lim in checks.values()), checks

    def altered(change):
        res = [(c, [r.copy() for r in rows]) for c, rows in good]
        change(res[1][1])
        return _checks(prepared, x, res)

    limit = bench_ref.LIMITS["sam_edge_err"]

    def scale_row(rows):
        rows[0] *= np.float16(1 + 2 * bench_ref.LIMITS["sam_embed_err"])

    def drop_row(rows):
        rows.pop()

    def reshape_row(rows):
        rows[0] = rows[0][:, :-1]

    def nan_row(rows):
        rows[1][0, 0, 0] = np.nan

    def pad_windows(rows):
        # a fault confined to the windows that hold padding (grid rows
        # and columns 8 and 9 of 10): 1.2 times the limit there, which
        # the whole grid dilutes below its own
        r = rows[0].astype(np.float32)
        edge = bench_ref.edge_mask(SMALL, "cpu").numpy()
        noise = np.random.default_rng(0).standard_normal(r.shape)
        noise[..., ~edge] = 0
        r += noise * 1.2 * limit * np.linalg.norm(r[..., edge]) \
            / np.linalg.norm(noise)
        rows[0] = r.astype(np.float16)

    for change, name in ((scale_row, "sam_embed_err"),
                         (drop_row, "sam_rows_missing"),
                         (reshape_row, "sam_rows_missing"),
                         (nan_row, "sam_embed_err"),
                         (pad_windows, "sam_edge_err")):
        got = altered(change)
        value, lim = got[name]
        assert value > lim, (change.__name__, got)
    got = altered(pad_windows)
    assert got["sam_embed_err"][0] <= got["sam_embed_err"][1], got


@pytest.mark.parametrize("control", ["fp8", "no_rel_pos", "windowed_global",
                                     "masked_pad"])
def test_control_is_not_correct(prepared, control, monkeypatch):
    """Each control in the program's place fails at least one limit."""
    monkeypatch.setenv("SAM_CONTROL", control)
    x = tiny(2)
    low = bench_ref.control_results(small_config(), prepared, x, [(0, 2)],
                                    "cpu")
    checks = _checks(prepared, x, low)
    assert any(v > lim for v, lim in checks.values()), checks


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    dest = tiny_root(str(tmp_path_factory.mktemp("bench_sam")))
    path = os.path.join(dest, "benchmark", "configs",
                        "sam_vit_h_640x480.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["net"].update(SMALL)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return dest


def test_tiny_run_is_correct_and_traced(root, capsys):
    rc, out = run_tiny(root, "sam.bulk", capsys, trace=1)
    assert rc == 0 and out["correct"] and out["failed"] == 0, out
    assert set(out["checks"]) == {"sam_embed_err", "sam_edge_err",
                                  "sam_rows_missing"}
    for m in ("eval_ms_per_frame.sam", "sam_net_ms_per_frame",
              "save_ms_per_frame.sam"):
        assert out["metrics"][m]["value"] > 0
    # no listed peak for the CPU
    assert "sam_mfu" not in out["metrics"]
    assert "sam_attn_roofline" not in out["metrics"]


def test_altered_embedding_is_not_correct(root, capsys, monkeypatch):
    from scanner_tpu_torch.models import sam as op
    sound = op.SamEmbed.execute

    def broken(self, *args, **kw):
        out = np.array(sound(self, *args, **kw))
        out[:, 0] += 1.0          # the first channel moved everywhere
        return out

    monkeypatch.setattr(op.SamEmbed, "execute", broken)
    rc, out = run_tiny(root, "sam.bulk", capsys)
    assert rc == 0 and out is not None
    assert out["correct"] is False, out
