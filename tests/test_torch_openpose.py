"""OpenPose (COCO body, 6 stages) in the port, scanner_tpu_torch.models
.openpose, against its plain float32 reference tests/torch_openpose_ref.py.

On the CPU the network runs at narrow widths (every layer and all six
stages kept) on seeded weights; the input is the op's own 368 x 496 net
resolution.  One test, marked `cuda`, runs the op at the published
widths on the card and skips without one.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import scanner_tpu_torch as st
import torch_openpose_ref as ref
from scanner_tpu_torch.common import DeviceType
from scanner_tpu_torch.graph.ops import KernelConfig
from scanner_tpu_torch.models import openpose as op
from scanner_tpu_torch.util import profiler as prof_mod
from torch.utils.flop_counter import FlopCounterMode
from torch_model_checks import stop_process_engine  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
NARROW = dict(conv1=4, conv2=8, conv3=16, conv4=32, cpm=16, features=8,
              stage1=8, stage1_hidden=32, stage=8)
SEED = 2 ** 33 + 19
MARGIN = 0.02       # twice the score tolerance: ties, on heatmap values


def frames(n=4, h=48, w=64, seed=SEED):
    g = torch.Generator().manual_seed(seed)
    f = torch.randint(0, 16, (n, h, w, 3), generator=g, dtype=torch.uint8)
    f[..., 1] += torch.linspace(0, 239, w).to(torch.uint8)
    f[:, h // 4:h // 2, w // 4:w // 2, 2] += 200
    return f


def save(state, path):
    """Caffe-named weights as the `.npz` the op loads."""
    np.savez(path, **{k: v.numpy() for k, v in state.items()})


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Narrow caffe-named weights (the reference's seeded init) and the
    `.npz` the op loads."""
    w = ref.init_weights(SEED, NARROW)
    path = str(tmp_path_factory.mktemp("openpose") / "narrow.npz")
    save(w, path)
    return w, path


def test_published_widths_depth_and_operations():
    with torch.device("meta"):
        net = op.OpenPoseNet()
    assert sum(p.numel() for p in net.parameters()) == 52_311_446
    assert len(net.specs) == 92
    assert [s[0] for s in net.specs] == [s[0] for s in ref.layers()]
    assert op.net_size(480, 640) == (368, 491, 496)
    assert op.net_flops(368, 496) == 366_430_800_896


def test_network_fp32_matches_reference(weights):
    """The port's network in float32 against the reference: the same
    convolutions in the same order, so only summation order differs
    (1e-5 of the maps' scale)."""
    w, _ = weights
    net = op.OpenPoseNet(**NARROW).eval()
    net.load_state_dict({"layers." + k.replace("/", "."): v
                         for k, v in w.items()})
    x = frames(2)
    with torch.no_grad():
        l1, l2 = net(op.prep(x, torch.float32))
        r1, r2 = ref.network(w, ref.prep(x))
    assert torch.equal(op.prep(x, torch.float32), ref.prep(x).contiguous(
        memory_format=torch.channels_last))
    for got, want in ((l1, r1), (l2, r2)):
        scale = want.abs().max()
        assert (got - want).abs().max() <= 1e-5 * scale


def test_bf16_op_matches_reference(weights):
    """The bf16 op's rows against the float32 reference's maps at the
    same pixels.  bf16 keeps 8 bits of mantissa: each of the 59
    convolutions on the deepest path rounds its input and weights by up
    to 2^-9 relative, so the maps move by a few thousandths of their
    ~0.1 spread (measured up to 0.006 on these weights): scores within
    0.02, pair scores (means of PAF values spreading ~1) within 0.06.
    A stored peak need not sit on the reference's own top pixel:
    upsampling by 8 leaves a peak's neighbours within ~1e-3 of it, less
    than bf16 moves the maps, so ties are judged by the reference's
    values within MARGIN: every stored peak is a reference 3x3 local
    maximum within MARGIN, and every reference peak that beats the 16th
    stored score by MARGIN has a stored peak on its bump (the reference
    within MARGIN of the peak all along the segment between them: a
    bump that rises above its saddle with a higher one by less than the
    maps' error merges into it)."""
    w, path = weights
    k = op.OpenPose(KernelConfig(device=DeviceType.TPU), checkpoint_dir=path)
    x = frames(3)
    got = k.execute(x.numpy())
    assert got.shape == (3, op.ROW_LEN) and got.dtype == np.float32
    heat, paf = ref.maps(w, x)
    nb = ref.neighbours_max(heat[:, :18])
    rx, ry, rs, rv = ref.peaks(heat, 64)
    for b in range(3):
        pose = op.unpack_pose(got[b])
        pk = pose["peaks"]
        valid = pk[..., 3] > 0.5
        assert valid.any()
        xs = np.rint(pk[..., 0] * 368 / 48).astype(int)
        ys = np.rint(pk[..., 1] * 368 / 48).astype(int)
        part = np.arange(18)[:, None].repeat(16, 1)
        at = heat[b, part, ys, xs].numpy()
        assert np.abs(pk[..., 2] - at)[valid].max() <= 0.02
        assert (at > nb[b, part, ys, xs].numpy() - MARGIN)[valid].all()
        for p in range(18):
            kth = pk[p, -1, 2] if valid[p].all() else ref.THRESH
            for a, c, s_, v in zip(rx[b, p], ry[b, p], rs[b, p], rv[b, p]):
                if v and s_ > kth + MARGIN:
                    assert any(_same_bump(heat[b, p], (int(a), int(c)),
                                          (xs[p, i], ys[p, i]), s_ - MARGIN)
                               for i in np.flatnonzero(valid[p]))
        for li, (pa, pb) in enumerate(ref.LIMBS):
            want = ref.line_integral(paf[b], li, xs[pa][:, None],
                                     ys[pa][:, None], xs[pb][None, :],
                                     ys[pb][None, :]).numpy()
            ok = valid[pa][:, None] & valid[pb][None, :]
            assert np.abs(pose["pairs"][li] - want)[ok].max() <= 0.06
            assert not pose["pairs"][li][~ok].any()


def _same_bump(hm, q, s, floor, samples=33):
    """Whether `hm` stays at or above `floor` all along the segment from
    pixel q to pixel s."""
    t = torch.linspace(0, 1, samples)
    xs = torch.round(q[0] + (s[0] - q[0]) * t).long()
    ys = torch.round(q[1] + (s[1] - q[1]) * t).long()
    return bool(hm[ys, xs].min() >= floor)


def _handmade_maps():
    """Stride-8 maps (1, 38, 46, 62) PAFs and (1, 19, 46, 62) heatmaps of
    two people side by side: a Gaussian of amplitude 0.9 at each part
    (off the grid, so a peak has one top pixel), and each limb's unit
    vector on the cells within one cell of its segment."""
    person = {0: (15, 8), 1: (15, 12), 2: (12, 12), 3: (11, 17),
              4: (11, 22), 5: (18, 12), 6: (19, 17), 7: (19, 22),
              8: (13, 24), 9: (13, 31), 10: (13, 38), 11: (17, 24),
              12: (17, 31), 13: (17, 38), 14: (14, 6), 15: (16, 6),
              16: (12, 8), 17: (18, 8)}
    h, w = 46, 62
    heat = torch.zeros(1, 19, h, w)
    paf = torch.zeros(1, 38, h, w)
    yy, xx = torch.meshgrid(torch.arange(h).float(),
                            torch.arange(w).float(), indexing="ij")
    people = []
    for shift in (0, 28):
        pts = {p: (x + shift + 0.3, y + 0.2) for p, (x, y) in person.items()}
        people.append(pts)
        for p, (x, y) in pts.items():
            heat[0, p] = torch.maximum(heat[0, p], 0.9 * torch.exp(
                -((xx - x) ** 2 + (yy - y) ** 2) / 2))
        for li, (pa, pb) in enumerate(op.LIMBS):
            (ax, ay), (bx, by) = pts[pa], pts[pb]
            d = torch.tensor([bx - ax, by - ay])
            u = d / d.norm()
            t = (((xx - ax) * d[0] + (yy - ay) * d[1]) / d.dot(d)).clamp(0, 1)
            near = torch.hypot(xx - ax - t * d[0], yy - ay - t * d[1]) <= 1
            cx, cy = op.LIMB_PAF[li]
            paf[0, cx][near] = u[0]
            paf[0, cy][near] = u[1]
    heat[0, 18] = 1 - heat[0, :18].amax(0)
    return paf, heat, people


def test_post_and_people_on_handmade_maps():
    paf, heat, people = _handmade_maps()
    got = op.post(paf, heat, 480, op.limb_indices()).numpy()
    want = ref.rows_from_maps(op.upsample(heat), op.upsample(paf), 480)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    pose = op.unpack_pose(got[0])
    found = op.assemble_people(pose, 480)
    assert len(found) == 2
    theirs = ref.assemble_people(pose["peaks"], pose["pairs"], 480)
    assert len(theirs) == 2
    for a, b in zip(found, theirs):
        np.testing.assert_array_equal(a, b)
    found.sort(key=lambda q: q[1, 0])
    for person, pts in zip(found, people):
        assert (person[:, 2] > 0.8).all()
        for p, (x, y) in pts.items():
            # a stride-8 cell's centre lies at 8 c + 3.5 net pixels
            want = np.array([8 * x + 3.5, 8 * y + 3.5]) * 480 / 368
            assert np.abs(person[p, :2] - want).max() <= 2.0


def test_people_agree_with_reference_on_seeded_rows(weights):
    """On rows of seeded weights (dense, random peaks and pair scores)
    the port's assembly and the reference's find the same people."""
    _, path = weights
    k = op.OpenPose(KernelConfig(device=DeviceType.TPU), checkpoint_dir=path)
    for row in k.execute(frames(2).numpy()):
        pose = op.unpack_pose(row)
        mine = op.assemble_people(pose, 48)
        theirs = ref.assemble_people(pose["peaks"], pose["pairs"], 48)
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)


def test_caffe_named_npz_round_trip(weights, tmp_path):
    w, path = weights
    with np.load(path) as data:
        keys = set(data)
    assert {"conv1_1/weight", "conv4_3_CPM/bias", "conv5_5_CPM_L2/weight",
            "Mconv1_stage2_L2/bias", "Mconv7_stage6_L1/weight"} <= keys
    assert len(keys) == 2 * 92
    net = op.load_weights(path, 0, "cpu")
    assert net.widths == dict(NARROW, stages=6)
    for name, *_ in net.specs:
        for leaf in ("weight", "bias"):
            got = getattr(net.layers[name], leaf)
            assert got.dtype == torch.bfloat16
            assert torch.equal(got, w[f"{name}/{leaf}"].to(torch.bfloat16))
    # a directory holding the file loads the same; the weights are shared
    again = op.load_weights(os.path.dirname(path), 0, "cpu")
    assert again.layers["conv1_1"].weight.data_ptr() == \
        net.layers["conv1_1"].weight.data_ptr()
    # the op's own seeded weights, written and read back
    seeded = op.seeded_state(3, NARROW)
    save(seeded, str(tmp_path / "s.npz"))
    back = op.load_weights(str(tmp_path / "s.npz"), 0, "cpu")
    assert torch.equal(back.layers["Mconv7_stage6_L2"].bias,
                       seeded["Mconv7_stage6_L2/bias"].to(torch.bfloat16))
    del seeded["conv2_2/bias"]
    save(seeded, str(tmp_path / "broken.npz"))
    with pytest.raises(KeyError):
        op.load_weights(str(tmp_path / "broken.npz"), 0, "cpu")


def test_cost_counts_the_networks_convolutions(weights):
    """cost() and infer_cost_flops give the network's convolutions as
    FlopCounterMode counts them (the post-processing is not counted)."""
    _, path = weights
    k = op.OpenPose(KernelConfig(device=DeviceType.TPU), checkpoint_dir=path)
    x = frames(2)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        k._dp.module.net(op.prep(x))
    c = k.cost([tuple(x.shape)])
    assert c["flops"] == counter.get_total_flops() == \
        2 * op.net_flops(368, 496, NARROW)
    assert k.infer_cost_flops(x.numpy()) == c["flops"]
    assert c["bytes_in"] == x.numel()
    assert c["bytes_out"] == 2 * op.ROW_LEN * 4


def test_spans_record_only_under_a_current_profiler():
    p = prof_mod.Profiler()
    with prof_mod.span("outside"):
        pass
    with prof_mod.recording_into(p):
        with prof_mod.span("inside"):
            pass
    with prof_mod.span("after"):
        pass
    assert [iv.name for iv in p.intervals()] == ["inside"]


def test_op_through_client_run(weights, tmp_path):
    """OpenPose through Client.run on the CPU (the normal path): the
    stored rows equal the op called directly, and the job's profile
    holds the op's three spans inside its evaluate:OpenPose spans."""
    _, path = weights
    x = frames(6, seed=SEED + 1)
    k = op.OpenPose(KernelConfig(device=DeviceType.TPU), checkpoint_dir=path)
    want = np.concatenate([k.execute(x[:4].numpy()),
                           k.execute(x[4:].numpy())])
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    try:
        sc.new_table("frames", ["frame"], [[f] for f in x.numpy()],
                     codecs={"frame": "pickle"})
        poses = sc.ops.OpenPose(
            frame=sc.io.Input([st.NamedStream(sc, "frames")]),
            checkpoint_dir=path)
        out = st.NamedStream(sc, "poses")
        jid = sc.run(sc.io.Output(poses, [out]), st.PerfParams.manual(4, 4),
                     cache_mode=st.CacheMode.Overwrite, show_progress=False)
        got = np.stack(list(out.load()))
        profile = sc.get_profile(jid)
    finally:
        sc.stop()
    assert got.shape == (6, op.ROW_LEN)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    ivs = [iv for p in profile.profilers for iv in p.intervals()]
    evals = [iv for iv in ivs if iv.name == "evaluate:OpenPose"]
    assert len(evals) == 2
    for name in ("openpose:prep", "openpose:net", "openpose:post"):
        mine = [iv for iv in ivs if iv.name == name]
        assert len(mine) == 2, name
        for iv in mine:
            assert any(e.start <= iv.start <= iv.end <= e.end
                       and e.thread == iv.thread for e in evals)


def test_imports_stand_alone():
    """The op's module imports with jax and the JAX package unavailable;
    the reference imports nothing of the program either."""
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, *a):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax',"
            " 'scanner_tpu'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import scanner_tpu_torch.models.openpose as op\n"
            "import torch_openpose_ref\n"
            "assert op.OpenPose and torch_openpose_ref.network\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE), HERE]))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    tree = ast.parse(open(os.path.join(HERE, "torch_openpose_ref.py")).read())
    mods = {(n.module or "") if isinstance(n, ast.ImportFrom) else a.name
            for n in ast.walk(tree)
            if isinstance(n, (ast.Import, ast.ImportFrom))
            for a in n.names}
    assert {m.split(".")[0] for m in mods} <= {
        "__future__", "math", "typing", "numpy", "torch"}


@pytest.mark.cuda
def test_published_widths_on_the_card(tmp_path):
    """The op at the published widths on the card against the float32
    reference on 16 frames of 480 x 640: scores within 0.02 of the
    reference's maps at the same pixels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the published widths run there")
    dev = torch.device("cuda")
    w = ref.init_weights(SEED, device=dev)
    path = str(tmp_path / "published.npz")
    save({k: v.cpu() for k, v in w.items()}, path)
    k = op.OpenPose(KernelConfig(device=DeviceType.TPU, devices=[dev]),
                    checkpoint_dir=path)
    x = frames(16, 480, 640).to(dev)
    got = k.execute(x).cpu().numpy()
    heat, _ = ref.maps(w, x)
    for b in range(16):
        pk = op.unpack_pose(got[b])["peaks"]
        valid = pk[..., 3] > 0.5
        xs = np.rint(pk[..., 0] * 368 / 480).astype(int)
        ys = np.rint(pk[..., 1] * 368 / 480).astype(int)
        part = np.arange(18)[:, None].repeat(16, 1)
        at = heat[b, part, ys, xs].cpu().numpy()
        assert valid.any()
        assert np.abs(pk[..., 2] - at)[valid].max() <= 0.02
