"""SAM's ViT-H image encoder in the port, scanner_tpu_torch.models.sam,
against its plain float32 reference tests/torch_sam_ref.py.

On the CPU the encoder runs at a small size that keeps every kind of
block: width 64, 2 heads, depth 4 with global blocks at 1 and 3,
window 4, a 160 x 160 input (a 10 x 10 grid that the windowed blocks
pad to 12, so the padded keys are exercised).  One test, marked `cuda`,
runs the op at the published sizes on the card and skips without one.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import scanner_tpu_torch as st
import torch_sam_ref as ref
from scanner_tpu_torch.common import DeviceType
from scanner_tpu_torch.graph.ops import KernelConfig
from scanner_tpu_torch.kernels import attention
from scanner_tpu_torch.models import sam
from scanner_tpu_torch.util import profiler as prof_mod
from torch_model_checks import stop_process_engine  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
SMALL = dict(img_size=160, patch=16, width=64, depth=4, heads=2, mlp=256,
             window=4, global_blocks=[1, 3], out=32)
SEED = 2 ** 33 + 29
# bf16 rounds every operand by up to 2^-9 relative; through 4 blocks and
# the neck the embedding moves by ~1.2 % of its norm (measured 1.1-1.2 %
# on these weights), so 3 %; every control departs by 17 % or more
BF16_TOL = 0.03


def frames(n=3, h=48, w=64, seed=SEED):
    g = torch.Generator().manual_seed(seed)
    f = torch.randint(0, 200, (n, h, w, 3), generator=g, dtype=torch.uint8)
    f[:, h // 4:h // 2, w // 4:w // 2, 2] += 50
    return f


def rel_err(got, want):
    """Per row ||got - want|| / ||want||."""
    return ((got - want).flatten(1).norm(dim=1)
            / want.flatten(1).norm(dim=1))


def bias_bytes_per_frame(arch):
    """What rel_pos_attention writes for one frame: an (S, S) bf16 bias
    per head and window of every block."""
    g = arch["img_size"] // arch["patch"]
    ws = arch["window"]
    windows = (-(-g // ws)) ** 2
    total = 0
    for i in range(arch["depth"]):
        n, s = (1, g * g) if i in arch["global_blocks"] else (windows,
                                                              ws * ws)
        total += n * arch["heads"] * s * s * 2
    return total


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """Small SAM-named weights (the reference's seeded draw) and the
    `.npz` of bfloat16 bits the op loads."""
    w = ref.init_weights(SEED, SMALL)
    path = str(tmp_path_factory.mktemp("sam") / "small.npz")
    sam.save_state(w, path)
    return w, path


def test_published_sizes_parameters_and_operations():
    """637,026,048 parameters and 5,961.08 GFLOP a frame follow from the
    published widths (built on the meta device)."""
    with torch.device("meta"):
        enc = sam.SamEncoder()
    assert sum(p.numel() for p in enc.parameters()) == 637_026_048
    assert {k: tuple(v.shape) for k, v in enc.state_dict().items()} == \
        sam.state_shapes() == ref.shapes()
    assert enc.arch == dict(sam.PUBLISHED)
    assert [b.window for b in enc.blocks] == [
        0 if i in (7, 15, 23, 31) else 14 for i in range(32)]
    assert sam.encoder_flops() == 5_961_082_830_848
    assert sam.attention_flops() == 481_280_327_680
    # by hand, the four global blocks' products: 16 heads x 4096^2 x 80
    assert 4 * 2 * 2 * 16 * 4096 ** 2 * 80 == 343_597_383_680


def test_seeded_state_is_the_references_draw(weights):
    w, _ = weights
    mine = sam.seeded_state(SEED, SMALL)
    assert mine.keys() == w.keys()
    assert all(torch.equal(mine[k], w[k]) for k in w)
    assert sam.arch_of(w) == dict(SMALL, global_blocks=(1, 3))
    assert ref.arch_of(w) == SMALL
    # the tables and the position embedding are drawn non-zero
    assert w["pos_embed"].std() > 0.3
    assert w["blocks.0.attn.rel_pos_h"].std() > 0.05


def test_window_partition_pads_and_round_trips():
    x = torch.randn(2, 10, 10, 3)
    win, padded = sam.window_partition(x, 4)
    assert win.shape == (2 * 9, 4, 4, 3) and padded == (12, 12)
    assert not win[2, :, 2:].any() and not win[8, 2:].any()
    assert torch.equal(sam.window_unpartition(win, 4, padded, (10, 10)), x)
    ref_win, _ = ref.window_partition(x, 4)
    assert torch.equal(win, ref_win)


def test_rel_pos_attention_matches_the_plain_formula():
    """The attention entry against softmax(q k^T / sqrt(d) + rel_h +
    rel_w) v written out; a key grid that does not match the keys is
    refused."""
    g = torch.Generator().manual_seed(5)
    n, h, kh, kw, d = 3, 2, 3, 5, 8
    q, k, v = (torch.randn(n, h, kh * kw, d, generator=g) for _ in range(3))
    rel_h = torch.randn(n, h, kh * kw, kh, generator=g)
    rel_w = torch.randn(n, h, kh * kw, kw, generator=g)
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(
        n, h, kh * kw, kh * kw)
    want = torch.softmax(q @ k.transpose(-2, -1) / d ** 0.5 + bias, -1) @ v
    got = attention.rel_pos_attention(q, k, v, rel_h, rel_w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        attention.rel_pos_attention(q, k, v, rel_h[..., :2], rel_w)


def test_encoder_fp32_matches_reference(weights):
    """The port's encoder in float32 against the reference: the same
    operations, the attention by SDPA with the bias as a mask, so only
    summation order differs (1e-5 of the embedding's norm)."""
    w, path = weights
    enc = sam.load_encoder(path, 0, "cpu", torch.float32)
    model = sam.SamEmbedModel(enc)
    x = frames()
    net_in = sam.prep(x, 160, model.mean, model.std, torch.float32)
    assert torch.equal(net_in, ref.prep(x, 160))
    with torch.no_grad():
        got = enc(net_in)
        want = ref.embed(w, x)
    assert got.shape == want.shape == (3, 32, 10, 10)
    assert rel_err(got, want).max() <= 1e-5


def test_bf16_op_matches_reference(weights):
    """The bf16 op's float16 rows against the float32 reference within
    BF16_TOL of the embedding's norm, over the whole grid and over the
    padded windows' rows and columns alone; every control lies far
    outside it."""
    w, path = weights
    k = sam.SamEmbed(KernelConfig(device=DeviceType.TPU),
                     checkpoint_dir=path)
    x = frames()
    got = k.execute(x.numpy())
    assert got.shape == (3, 32, 10, 10) and got.dtype == np.float16
    want = ref.embed(w, x)
    got = torch.from_numpy(got).float()
    assert rel_err(got, want).max() <= BF16_TOL
    edge = torch.zeros(10, 10, dtype=torch.bool)
    edge[8:] = edge[:, 8:] = True
    assert rel_err(got[..., edge], want[..., edge]).max() <= BF16_TOL
    for control in ref.CONTROLS:
        with torch.no_grad():
            low = ref.embed(w, x, control)
        assert rel_err(low[..., edge], want[..., edge]).min() \
            > 2 * BF16_TOL, control


def test_npz_of_bf16_bits_round_trip(weights, tmp_path):
    w, path = weights
    with np.load(path) as data:
        assert set(data) == set(ref.shapes(SMALL))
        assert all(data[k].dtype == np.uint16 for k in data)
    enc = sam.load_encoder(path, 0, "cpu")
    for name, t in enc.state_dict().items():
        assert t.dtype == torch.bfloat16
        assert torch.equal(t.float(), w[name])
    # a directory holding the file loads the same; the weights are shared
    again = sam.load_encoder(os.path.dirname(path), 0, "cpu")
    assert again.pos_embed.data_ptr() == enc.pos_embed.data_ptr()
    # another dtype is another copy
    f32 = sam.load_encoder(path, 0, "cpu", torch.float32)
    assert f32.pos_embed.dtype == torch.float32
    broken = dict(w)
    del broken["blocks.2.mlp.lin2.bias"]
    sam.save_state(broken, str(tmp_path / "broken.npz"))
    with pytest.raises(KeyError):
        sam.load_encoder(str(tmp_path / "broken.npz"), 0, "cpu")


def test_cost_counts_the_encoder(weights):
    """cost() gives the encoder's operations: FlopCounterMode's count of
    its convolutions and matrix products, plus the attention's two
    products, which it does not count in the CPU's SDPA."""
    _, path = weights
    k = sam.SamEmbed(KernelConfig(device=DeviceType.TPU),
                     checkpoint_dir=path)
    x = frames(2)
    model = k._dp.module
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model.encoder(sam.prep(x, 160, model.mean, model.std))
    c = k.cost([tuple(x.shape)])
    assert c["flops"] == counter.get_total_flops() \
        + 2 * sam.attention_flops(SMALL) == 2 * sam.encoder_flops(SMALL)
    assert k.infer_cost_flops(x.numpy()) == c["flops"]
    assert c["bytes_in"] == x.numel()
    assert c["bytes_out"] == 2 * 32 * 10 * 10 * 2


def test_spans_and_counters_record_only_under_a_current_profiler(weights):
    """The model's spans and its two counters land in the current
    profiler, and nowhere without one (the evaluator's warm-up)."""
    _, path = weights
    model = sam.SamEmbedModel(sam.load_encoder(path, 0, "cpu"))
    x = frames(2)
    p = prof_mod.Profiler()
    with torch.no_grad():
        model(x)
        with prof_mod.recording_into(p):
            model(x)
        model(x)
    assert [iv.name for iv in p.intervals()] == ["sam:prep", "sam:net"]
    assert p.counters == {"sam_frames": 2, "sam_attn_bias_bytes":
                          2 * bias_bytes_per_frame(SMALL)}


def test_op_through_client_run(weights, tmp_path):
    """SamEmbed through Client.run on the CPU (the normal path): the
    stored rows equal the op called directly; the job's profile holds
    the op's spans inside its evaluate:SamEmbed spans, the save stage's
    fetch and write spans inside its save spans, and counters of the
    frames embedded (bucket padding included) and the bias bytes
    written."""
    _, path = weights
    x = frames(6, seed=SEED + 1)
    k = sam.SamEmbed(KernelConfig(device=DeviceType.TPU),
                     checkpoint_dir=path)
    want = np.concatenate([k.execute(x[:4].numpy()),
                           k.execute(x[4:].numpy())])
    sc = st.Client(db_path=str(tmp_path / "db"), device="cpu")
    try:
        sc.new_table("frames", ["frame"], [[f] for f in x.numpy()],
                     codecs={"frame": "pickle"})
        emb = sc.ops.SamEmbed(
            frame=sc.io.Input([st.NamedStream(sc, "frames")]),
            checkpoint_dir=path)
        out = st.NamedStream(sc, "embeddings")
        jid = sc.run(sc.io.Output(emb, [out]), st.PerfParams.manual(4, 4),
                     cache_mode=st.CacheMode.Overwrite, show_progress=False)
        got = np.stack(list(out.load()))
        profile = sc.get_profile(jid)
    finally:
        sc.stop()
    assert got.shape == (6, 32, 10, 10) and got.dtype == np.float16
    np.testing.assert_array_equal(got, want)
    ivs = [iv for p in profile.profilers for iv in p.intervals()]
    for inner, outer, n in (("sam:prep", "evaluate:SamEmbed", 2),
                            ("sam:net", "evaluate:SamEmbed", 2),
                            ("save:fetch", "save", 2),
                            ("save:write", "save", 2)):
        outers = [iv for iv in ivs if iv.name == outer]
        mine = [iv for iv in ivs if iv.name == inner]
        assert len(mine) == n, inner
        for iv in mine:
            assert any(e.start <= iv.start <= iv.end <= e.end
                       and e.thread == iv.thread for e in outers)
    # the tail task's 2 frames are padded to the op's smallest bucket, 4
    # (engine/evaluate.py bucket_ladder): the op embeds 8 frames
    counters = profile.statistics()["_counters"]
    assert counters["sam_frames"] == 8
    assert counters["sam_attn_bias_bytes"] == 8 * bias_bytes_per_frame(SMALL)


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
            "import scanner_tpu_torch.models.sam as sam\n"
            "import torch_sam_ref\n"
            "assert sam.SamEmbed and torch_sam_ref.encoder\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE), HERE]))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    tree = ast.parse(open(os.path.join(HERE, "torch_sam_ref.py")).read())
    mods = {(n.module or "") if isinstance(n, ast.ImportFrom) else a.name
            for n in ast.walk(tree)
            if isinstance(n, (ast.Import, ast.ImportFrom))
            for a in n.names}
    assert {m.split(".")[0] for m in mods} <= {
        "__future__", "math", "typing", "torch"}


@pytest.mark.cuda
def test_published_sizes_on_the_card(tmp_path):
    """The op at the published sizes on the card against the float32
    reference on 4 frames of 480 x 640: within 3 % of the embedding's
    norm (the benchmark's judge holds every stored row to its limits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the published sizes run there")
    dev = torch.device("cuda")
    w = ref.init_weights(SEED, device=dev)
    path = str(tmp_path / "published.npz")
    sam.save_state(w, path)
    k = sam.SamEmbed(KernelConfig(device=DeviceType.TPU, devices=[dev]),
                     checkpoint_dir=path)
    x = frames(4, 480, 640).to(dev)
    got = k.execute(x)
    assert got.shape == (4, 256, 64, 64) and got.dtype == torch.float16
    with torch.no_grad():
        want = ref.embed(w, x)
    assert rel_err(got.float(), want).max() <= BF16_TOL
