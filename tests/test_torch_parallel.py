"""In-program sharding primitives: the port on four gloo ranks on the CPU
against the JAX package under shard_map on the conftest's 8-device CPU
mesh (a prefix of its devices), on the same numpy inputs.

The ranks (tests/torch_mesh_worker.py, mode "parallel") are spawned once
for the module and run every case; each test reads its part of their
results.  Tolerances:
  * placements, temporal_diff and the stencil: exact (int32 rows, and
    each rank's block is the JAX shard of the same mesh coordinate);
  * Ulysses outputs and gradients: rtol 2e-4, atol 2e-5 (the JAX
    package's own Ulysses tolerance, tests/test_parallel.py);
  * the pipeline's outputs and gradients: rtol 1e-5, atol 1e-5 (f32
    tanh stages; the JAX package holds its schedule to the sequential
    loop at atol 1e-5);
  * the rejections: the port's ValueError says the JAX package's words.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scanner_tpu.parallel import distributed as jdist
from scanner_tpu.parallel import halo as jhalo
from scanner_tpu.parallel import mesh as jmesh
from scanner_tpu.parallel import pp as jpp
from scanner_tpu.parallel.ulysses import make_ulysses_attention

from torch_mesh_worker import finish_ranks, start_ranks

ULY_TOL = dict(rtol=2e-4, atol=2e-5)
PIPE_TOL = dict(rtol=1e-5, atol=1e-5)
ULY_SHAPES = {"sp4": (2, 32, 4, 16), "sp2": (2, 16, 2, 8)}


def _inputs():
    rng = np.random.RandomState(0)
    d = {"placed": rng.randn(8, 6).astype(np.float32),
         "rows": rng.randint(-1000, 1000, (32, 3)).astype(np.int32),
         "pipe_x": rng.randn(8, 6, 16).astype(np.float32),
         "pipe_w": (rng.randn(2, 16, 16) * 0.1).astype(np.float32),
         "pipe_b": (rng.randn(2, 16) * 0.1).astype(np.float32)}
    for tag, shape in ULY_SHAPES.items():
        for a in "qkvw":
            d[f"{tag}_{a}"] = rng.randn(*shape).astype(np.float32)
    return d


@pytest.fixture(scope="module")
def data():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, data):
    work = str(tmp_path_factory.mktemp("mesh_parallel"))
    src = os.path.join(work, "in.npz")
    np.savez(src, **data)
    return finish_ranks(start_ranks("parallel", src, work), work)


def _jax_error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def _shard_at(arr, mesh, coord):
    dev = mesh.devices[tuple(coord)]
    return next(np.asarray(s.data) for s in arr.addressable_shards
                if s.device == dev)


@pytest.mark.parametrize("case,axes,spec", [
    ("dp", {"dp": 2, "sp": 2, "tp": 1}, ("dp",)),
    ("dp_sp", {"dp": 2, "sp": 2, "tp": 1}, ("dp", "sp")),
    ("none_tp", {"dp": 2, "sp": 1, "tp": 2}, (None, "tp")),
])
def test_placements_match_jax_shards(ranks, data, case, axes, spec):
    """shard_batch and replicate_to_global: each rank's block is the JAX
    array's shard on the device at the same mesh coordinate."""
    mesh = jmesh.make_mesh(axes)
    if spec == ("dp",):
        arr = jmesh.shard_batch(mesh, data["placed"])
    else:
        arr = jdist.replicate_to_global(mesh, spec, data["placed"])
    coord_key = "coord_dp_tp" if "tp" in spec else "coord_dp_sp"
    for out in ranks:
        want = _shard_at(arr, mesh, out[coord_key])
        np.testing.assert_array_equal(out[f"place_{case}"], want)


def test_sharding_names_its_placements(ranks):
    """sharding(mesh, "dp", "sp"): Shard(0) on dp, Shard(1) on sp,
    Replicate() on the tp the spec does not name."""
    want = ["Shard(0)", "Shard(1)", "Replicate()"]
    for out in ranks:
        assert list(out["placements_dp_sp"]) == want


def test_sharding_without_a_process_group():
    """On a MeshLayout, sharding gives placements with no process group
    (param_shardings uses this), and rejects an axis twice or an
    unknown one."""
    from torch.distributed.tensor import Shard
    from scanner_tpu_torch.parallel.mesh import make_mesh, sharding
    lay = make_mesh({"dp": 2, "sp": 2, "tp": 2}, devices=["cpu"] * 8)
    sh = sharding(lay, ("dp", "sp"), None, "tp")
    assert sh.mesh is lay
    assert list(sh.placements) == [Shard(0), Shard(0), Shard(2)]
    with pytest.raises(ValueError, match="twice"):
        sharding(lay, "dp", "dp")
    with pytest.raises(ValueError, match="not in the mesh"):
        sharding(lay, "pp")


def test_temporal_diff_matches_jax(ranks, data):
    """temporal_diff over 32 int32 rows on sp = 4, exactly the JAX
    package's (and the plain row difference with the first row
    repeated)."""
    mesh = jmesh.make_mesh({"sp": 4, "dp": 1, "tp": 1})
    want = np.asarray(jhalo.temporal_diff(mesh, axis="sp")(
        jnp.asarray(data["rows"])))
    got = np.concatenate([o["diff"] for o in ranks])
    np.testing.assert_array_equal(got, want)
    rows = data["rows"]
    np.testing.assert_array_equal(
        got, rows - np.concatenate([rows[:1], rows[:-1]]))


def test_wide_stencil_matches_jax(ranks, data):
    """Stencil [-2, 0, 1] across shard boundaries, REPEAT_EDGE at both
    ends, 16 rows over sp = 4."""
    mesh = jmesh.make_mesh({"sp": 4, "dp": 1, "tp": 1})
    f = jhalo.sharded_stencil_map(
        lambda p: p[:-3] + p[2:-1] + p[3:], stencil=[-2, 0, 1], mesh=mesh,
        axis="sp")
    want = np.asarray(f(jnp.asarray(data["rows"][:16])))
    np.testing.assert_array_equal(
        np.concatenate([o["wide"] for o in ranks]), want)


def test_multi_hop_stencil_error_keeps_jax_words(ranks, data):
    mesh = jmesh.make_mesh({"sp": 4, "dp": 1, "tp": 1})
    far = jhalo.sharded_stencil_map(lambda p: p[5:], stencil=[-5, 0],
                                    mesh=mesh, axis="sp")
    want = _jax_error(lambda: far(jnp.asarray(data["rows"][:16])))
    for out in ranks:
        assert str(out["err_multihop"]) == want


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tag", ["sp4", "sp2"])
def test_ulysses_matches_jax(ranks, data, tag, causal):
    """Outputs and q, k, v gradients of sum(out * w); at sp 2 each of the
    two dp rows runs its own Ulysses group on the same data."""
    n = int(tag[2:])
    mesh = jmesh.make_mesh({"sp": n, "dp": 1, "tp": 1})
    uly = make_ulysses_attention(mesh, axis="sp", causal=causal)
    q, k, v, w = (jnp.asarray(data[f"{tag}_{a}"]) for a in "qkvw")
    out, vjp = jax.vjp(uly, q, k, v)
    want = dict(zip(("out", "dq", "dk", "dv"), (out,) + vjp(w)))
    key = f"uly_{tag}_{int(causal)}"
    rows = [ranks[:n]] if n == 4 else [ranks[:2], ranks[2:]]
    for row in rows:   # world rank order is sp order within a dp row
        for name, ref in want.items():
            got = np.concatenate([o[f"{key}_{name}"] for o in row], axis=1)
            np.testing.assert_allclose(got, np.asarray(ref), **ULY_TOL,
                                       err_msg=f"{key} {name}")


def test_ulysses_rejects_indivisible_heads_in_jax_words(ranks):
    mesh = jmesh.make_mesh({"sp": 4, "dp": 1, "tp": 1})
    q = jnp.zeros((1, 4, 3, 8), jnp.float32)
    want = _jax_error(lambda: make_ulysses_attention(mesh, axis="sp")(
        q, q, q))
    for out in ranks:
        assert str(out["err_heads"]) == want


@pytest.mark.parametrize("M", [2, 4])
def test_pipeline_matches_jax(ranks, data, M):
    """make_pipeline at dp 2 x pp 2: every pp rank holds the JAX output
    of its dp rows; gradients of sum(y ** 2): each rank's stage gradient,
    summed over the dp ranks that hold that stage, is the JAX gradient of
    that stage, and the input's gradient summed over the pp ranks of a
    dp row is JAX's for those rows."""
    mesh = jmesh.make_mesh({"dp": 2, "sp": 1, "tp": 1, "pp": 2})

    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"] + p["b"])

    stacked = jpp.stack_stage_params(
        [{"w": data["pipe_w"][i], "b": data["pipe_b"][i]}
         for i in range(2)])
    pipe = jpp.make_pipeline(mesh, stage_fn, num_microbatches=M)
    x = jnp.asarray(data["pipe_x"])
    y = np.asarray(jax.jit(pipe)(stacked, x))
    gp, gx = jax.jit(jax.grad(lambda p, x: jnp.sum(pipe(p, x) ** 2),
                              argnums=(0, 1)))(stacked, x)
    b = x.shape[0] // 2
    coords = [tuple(o["coord_dp_pp"]) for o in ranks]   # (dp, sp, tp, pp)
    for d in range(2):
        rows = slice(d * b, (d + 1) * b)
        row = [o for o, c in zip(ranks, coords) if c[0] == d]
        for o in row:
            np.testing.assert_allclose(o[f"pipe_{M}_out"], y[rows],
                                       **PIPE_TOL)
        np.testing.assert_allclose(sum(o[f"pipe_{M}_dx"] for o in row),
                                   np.asarray(gx)[rows], **PIPE_TOL)
    for s in range(2):
        holders = [o for o, c in zip(ranks, coords) if c[3] == s]
        for k in ("w", "b"):
            got = sum(o[f"pipe_{M}_d{k}"][0] for o in holders)
            np.testing.assert_allclose(got, np.asarray(gp[k])[s],
                                       **PIPE_TOL, err_msg=f"d{k}[{s}]")


def test_pipeline_rejections_keep_jax_words(ranks):
    """M < 1, a per-shard batch M does not divide, and a stacked stage
    count other than the pp size."""
    mesh = jmesh.make_mesh({"dp": 1, "sp": 1, "tp": 1, "pp": 2})
    eye = np.eye(8, dtype=np.float32)
    micro = _jax_error(lambda: jpp.make_pipeline(
        mesh, lambda p, x: x @ p["w"], num_microbatches=3)(
            jpp.stack_stage_params([{"w": eye}] * 2),
            np.zeros((4, 2, 8), np.float32)))
    stages = _jax_error(lambda: jpp.make_pipeline(
        mesh, lambda p, x: x @ p["w"], num_microbatches=2)(
            jpp.stack_stage_params([{"w": eye}] * 4),
            np.zeros((4, 2, 8), np.float32)))
    m0 = _jax_error(lambda: jpp.make_pipeline(
        mesh, lambda p, x: x, num_microbatches=0))
    assert "not divisible" in micro and "must match" in stages
    for out in ranks:
        assert str(out["err_micro"]) == micro
        assert str(out["err_stages"]) == stages
        assert str(out["err_m0"]) == m0


def test_stack_stage_params_matches_jax():
    import torch
    from scanner_tpu_torch.parallel import stack_stage_params
    rng = np.random.RandomState(3)
    trees = [{"a": rng.randn(2, 3).astype(np.float32),
              "n": [rng.randn(4).astype(np.float32)]} for _ in range(3)]
    got = stack_stage_params(trees)
    want = jpp.stack_stage_params(trees)
    assert isinstance(got["a"], torch.Tensor)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(want["a"]))
    np.testing.assert_array_equal(got["n"][0].numpy(),
                                  np.asarray(want["n"][0]))


def test_device_mesh_needs_a_group_of_the_layout_size():
    """device_mesh raises without the caller's process group (or, where
    another test left one, with a group of another size)."""
    from scanner_tpu_torch.parallel import device_mesh, make_mesh
    with pytest.raises(ValueError, match="process group"):
        device_mesh(make_mesh({"dp": 2}, devices=["cpu"] * 2))


def test_multi_card_entry_points_still_refuse():
    """What needs several cards (ROADMAP A.7b(b)) raises, naming it."""
    import torch
    from scanner_tpu_torch.engine.service import Worker
    from scanner_tpu_torch.models.infer import DataParallelApply
    with pytest.raises(NotImplementedError, match=r"A\.7b\(b\)"):
        Worker("localhost:1", db_path="unused", coordinator=object(),
               device="cpu")
    with pytest.raises(NotImplementedError, match=r"A\.7b\(b\)"):
        DataParallelApply(torch.nn.Linear(2, 2), ["cpu", "cpu"])
