"""The flash-attention update and ring attention: the port against the
JAX package on the CPU, on the same numpy inputs.

  * `flash_block_update_plain` (what the wrapper runs on CPU tensors and
    what the CUDA kernel is held against on the card) against the JAX
    Pallas kernel in interpret mode: causal and not, nonzero offsets, a
    fully masked block, a chained two-block update, ragged T.
    Tolerance rtol 2e-4, atol 2e-5 (tests/test_parallel.py's): both are
    f32 with the same K tiles, and differ only in summation order;
  * `tf32_operand`, which gives the TF32 values the card's kernel
    multiplies: bit patterns (half-way cases, signs, zeros, infinities,
    the NEG_INF sentinel), bf16 values unchanged, and the plain version
    on TF32 operands within a stated bound of the plain version;
  * the port's ring (impl "xla" and "cuda") on one rank against the JAX
    ring on a one-device mesh and against `reference_attention`;
  * gradients of the "cuda" ring against jax.grad of the JAX Pallas
    ring (rtol 1e-5, atol 1e-6, test_parallel.py's: the same plain
    ring recomputes both backward passes);
  * a ring of two gloo ranks (spawned processes), forward and gradient,
    against the JAX ring on an sp=2 mesh.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scanner_tpu.kernels.pallas_attention import \
    flash_block_update as jax_flash
from scanner_tpu.parallel import make_mesh
from scanner_tpu.parallel import ring_attention as jring

from scanner_tpu_torch.kernels import attention as ta
from scanner_tpu_torch.parallel import ring_attention as tring

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 2e-4, 2e-5
NEG_INF = ta.NEG_INF


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: the suite runs files in parallel workers,
    and torch's default of one thread per core oversubscribes the host
    (timing-sensitive tests in other workers feel it)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(seed, BH, Tq, Tk, D, carry=False):
    rng = np.random.RandomState(seed)
    q = rng.randn(BH, Tq, D).astype(np.float32) * D ** -0.5
    k = rng.randn(BH, Tk, D).astype(np.float32)
    v = rng.randn(BH, Tk, D).astype(np.float32)
    if carry:   # the state after some earlier block: finite, l > 0
        m = rng.randn(BH, Tq).astype(np.float32)
        l = rng.uniform(0.5, 3.0, (BH, Tq)).astype(np.float32)
        acc = rng.randn(BH, Tq, D).astype(np.float32)
    else:
        m = np.full((BH, Tq), NEG_INF, np.float32)
        l = np.zeros((BH, Tq), np.float32)
        acc = np.zeros((BH, Tq, D), np.float32)
    return q, k, v, m, l, acc


def _both(args, q_off, k_off, causal, bq, bk):
    got = ta.flash_block_update(*(torch.from_numpy(a) for a in args),
                                q_off, k_off, causal=causal, block_q=bq,
                                block_k=bk)
    want = jax_flash(*(jnp.asarray(a) for a in args), q_off, k_off,
                     causal=causal, block_q=bq, block_k=bk, interpret=True)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def _close(got, want):
    for g, w, name in zip(got, want, ("m", "l", "acc")):
        assert g.dtype == np.float32
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


# (BH, Tq, Tk, D, q_off, k_off, causal, block_q, block_k, carry)
CASES = {
    "plain": (2, 16, 16, 8, 0, 0, False, 8, 8, False),
    "causal": (2, 16, 16, 8, 0, 0, True, 8, 8, False),
    "causal_offsets": (2, 16, 24, 8, 12, 4, True, 8, 8, True),
    "ragged": (3, 12, 20, 16, 5, 0, True, 8, 8, False),
    "ragged_d": (1, 9, 7, 5, 0, 0, False, 4, 4, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_plain_matches_pallas(case):
    BH, Tq, Tk, D, qo, ko, causal, bq, bk, carry = CASES[case]
    args = _inputs(sum(map(ord, case)), BH, Tq, Tk, D, carry)
    got, want = _both(args, qo, ko, causal, bq, bk)
    _close(got, want)


@pytest.mark.parametrize("carry", [False, True])
def test_flash_fully_masked_block_keeps_state(carry):
    """k_off past every query: every logit is masked.  An empty carry
    stays m = NEG_INF, l = 0, acc = 0; a set carry comes back unchanged;
    nothing is NaN or inf."""
    args = _inputs(3, 2, 8, 8, 8, carry)
    got, want = _both(args, 0, 100, True, 8, 8)
    _close(got, want)
    m0, l0, acc0 = args[3:]
    np.testing.assert_array_equal(got[0], m0)
    np.testing.assert_array_equal(got[1], l0)
    np.testing.assert_array_equal(got[2], acc0)


def test_flash_chained_two_blocks():
    """Two K/V blocks in turn from a set carry, as two ring steps."""
    q, k, v, m, l, acc = _inputs(4, 2, 16, 32, 8, carry=True)
    state_t = [torch.from_numpy(a) for a in (m, l, acc)]
    state_j = [jnp.asarray(a) for a in (m, l, acc)]
    for blk, k_off in ((slice(0, 16), 16), (slice(16, 32), 0)):
        state_t = ta.flash_block_update(
            torch.from_numpy(q), torch.from_numpy(k[:, blk]),
            torch.from_numpy(v[:, blk]), *state_t, 8, k_off, causal=True,
            block_q=8, block_k=8)
        state_j = jax_flash(jnp.asarray(q), jnp.asarray(k[:, blk]),
                            jnp.asarray(v[:, blk]), *state_j, 8, k_off,
                            causal=True, block_q=8, block_k=8,
                            interpret=True)
    _close([s.numpy() for s in state_t], [np.asarray(s) for s in state_j])


def test_flash_wrapper_validates_and_refuses_other_devices():
    args = [torch.from_numpy(a) for a in _inputs(5, 1, 4, 4, 4)]
    with pytest.raises(ValueError, match="block size"):
        ta.flash_block_update(*args, 0, 0, block_q=0)
    with pytest.raises(ValueError, match="carry shapes"):
        ta.flash_block_update(*args[:3], args[3][:, :2], *args[4:], 0, 0)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no flash-attention kernel"):
        ta.flash_block_update(*meta, 0, 0)
    before = ta.flash_launches
    ta.flash_block_update(*args, 0, 0)
    assert ta.flash_launches == before   # the plain version is no launch


# -- tf32_operand: the TF32 values the card's kernel multiplies ------------

def _bits(x):
    return x.view(torch.int32).numpy().astype(np.uint32)


def _from_bits(b):
    return torch.from_numpy(np.asarray(b, np.uint32).view(np.float32))


@pytest.mark.parametrize("rounding", ["rna", "trunc"])
def test_tf32_operand_keeps_bf16_values(rounding):
    """bf16 values (7 mantissa bits) are TF32 values (10 bits): both
    roundings leave them as they are."""
    x = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32)).to(torch.bfloat16).float()
    x = torch.cat([x, torch.tensor([0.0, -0.0, 1.0, -2.5, NEG_INF,
                                    float("inf"), float("-inf")])
                   .to(torch.bfloat16).float()])
    got = ta.tf32_operand(x, rounding)
    assert torch.equal(got.view(torch.int32), x.view(torch.int32))


# (bits in, rna bits out, trunc bits out): the low 13 bits are dropped;
# rna rounds half-way (0x1000) away from zero
TF32_BITS = [
    (0x3F800000, 0x3F800000, 0x3F800000),   # 1.0
    (0x3F800FFF, 0x3F800000, 0x3F800000),   # just below half-way
    (0x3F801000, 0x3F802000, 0x3F800000),   # half-way: away from zero
    (0x3F803000, 0x3F804000, 0x3F802000),   # half-way, odd TF32 lsb
    (0x3F801001, 0x3F802000, 0x3F800000),   # above half-way
    (0xBF801000, 0xBF802000, 0xBF800000),   # negative half-way
    (0xBF800FFF, 0xBF800000, 0xBF800000),
    (0x00000000, 0x00000000, 0x00000000),   # +0
    (0x80000000, 0x80000000, 0x80000000),   # -0
    (0x7F800000, 0x7F800000, 0x7F800000),   # +inf
    (0xFF800000, 0xFF800000, 0xFF800000),   # -inf
    (0xF149F2CA, 0xF14A0000, 0xF149E000),   # NEG_INF = -1e30
    (0x7F7FFFFF, 0x7F800000, 0x7F7FE000),   # largest f32 rounds to inf
    (0x00001000, 0x00002000, 0x00000000),   # subnormal half-way
    (0x3FFFF000, 0x40000000, 0x3FFFE000),   # carry into the exponent
]


@pytest.mark.parametrize("bits_in,rna,trunc", TF32_BITS,
                         ids=[f"{b[0]:08x}" for b in TF32_BITS])
def test_tf32_operand_bit_patterns(bits_in, rna, trunc):
    x = _from_bits([bits_in])
    assert _bits(ta.tf32_operand(x, "rna"))[0] == rna
    assert _bits(ta.tf32_operand(x, "trunc"))[0] == trunc


def test_tf32_operand_nan_and_bad_mode():
    x = torch.tensor([float("nan"), 1.0])
    for rounding in ("rna", "trunc"):
        assert torch.isnan(ta.tf32_operand(x, rounding)[0])
    with pytest.raises(ValueError, match="rounding"):
        ta.tf32_operand(x, "rn")


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_on_tf32_operands_within_bound(causal):
    """The plain version fed the kernel's TF32 operands (q, v rounded,
    k truncated) against the plain version on the originals, from an
    empty carry.  Per row, with d = 3 * 2^-11 * max_j sum_i |q_i k_ji|
    (q's relative error 2^-11 plus k's 2^-10 bounds every logit's change
    by d): |dm| <= d, |dl| / l <= e^(2d) - 1, and |d(acc / l)| <=
    (e^(2d) - 1 + 2^-11) * max|v|; plus 1e-6 for f32 arithmetic."""
    q, k, v, m, l, acc = (torch.from_numpy(a) for a in
                          _inputs(11, 3, 40, 56, 24))
    rounded = [ta.tf32_operand(t, ta.TF32_ROUNDING[n])
               for n, t in zip("qkv", (q, k, v))]
    assert not any(torch.equal(a, b) for a, b in zip(rounded, (q, k, v)))
    got = ta.flash_block_update_plain(*rounded, m, l, acc, 0, 0,
                                      causal=causal, block_k=8)
    want = ta.flash_block_update_plain(q, k, v, m, l, acc, 0, 0,
                                       causal=causal, block_k=8)
    d = 3 * 2.0 ** -11 * torch.bmm(q.abs(), k.abs().transpose(1, 2)) \
        .amax(dim=2)
    grow = torch.expm1(2 * d)
    out = [s[2] / s[1][..., None] for s in (got, want)]
    v_max = float(v.abs().max())
    assert ((got[0] - want[0]).abs() <= d + 1e-6).all()
    assert ((got[1] - want[1]).abs() <= grow * want[1] + 1e-6).all()
    assert ((out[0] - out[1]).abs()
            <= ((grow + 2.0 ** -11) * v_max + 1e-6)[..., None]).all()
    assert float((out[0] - out[1]).abs().max()) > 0


def _qkv(seed, B, T, H, D):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, T, H, D).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_one_rank_matches_jax(causal):
    """One rank: both impls against the JAX ring on a one-device mesh
    (XLA path, tiles of 8) and against reference_attention."""
    q, k, v = _qkv(7, 2, 32, 2, 16)
    mesh = make_mesh({"sp": 1, "dp": 1, "tp": 1},
                     devices=jax.devices()[:1])
    jx = np.asarray(jring.make_ring_attention(
        mesh, axis="sp", causal=causal, block_k=8)(
            *(jnp.asarray(a) for a in (q, k, v))))
    ref = tring.reference_attention(
        *(torch.from_numpy(a) for a in (q, k, v)), causal=causal).numpy()
    jref = np.asarray(jring.reference_attention(
        *(jnp.asarray(a) for a in (q, k, v)), causal=causal))
    np.testing.assert_allclose(ref, jref, rtol=RTOL, atol=ATOL)
    for impl in ("xla", "cuda"):
        ring = tring.make_ring_attention(None, causal=causal, impl=impl,
                                         block_k=8, block_q=8)
        got = ring(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
        np.testing.assert_allclose(got, jx, rtol=RTOL, atol=ATOL,
                                   err_msg=impl)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                   err_msg=impl)


def test_ring_rejects_bad_arguments():
    with pytest.raises(ValueError, match="impl"):
        tring.make_ring_attention(impl="pallas")
    with pytest.raises(ValueError, match="block_q"):
        tring.make_ring_attention(impl="cuda", block_q=0)
    assert tring._flash_block_k(32, 24) == 16
    assert tring._flash_block_k(32, 512) == 32
    assert tring._flash_block_k(7, 4) == 1


def test_ring_grad_matches_jax_pallas():
    """The "cuda" ring's backward recomputes through the plain ring: its
    gradients equal jax.grad of the JAX Pallas ring (sp=2)."""
    q, k, v = _qkv(8, 1, 16, 1, 8)
    mesh = make_mesh({"sp": 2, "dp": 1, "tp": 1})
    pal = jring.make_ring_attention(mesh, axis="sp", impl="pallas")
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jax.jit(jax.grad(lambda q, k, v: pal(q, k, v).sum(),
                            argnums=(0, 1, 2)))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tring.make_ring_attention(impl="cuda")(tq, tk, tv).sum().backward()
    for g, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6, err_msg=f"d{name}")


def test_ring_two_gloo_ranks_match_jax(tmp_path):
    """Two ranks over gloo, each holding half of T: forward and gradient
    of both impls, causal and not, against the JAX ring on sp=2."""
    B, T, H, D = 2, 16, 2, 8
    q, k, v = _qkv(9, B, T, H, D)
    w = np.random.RandomState(10).randn(B, T, H, D).astype(np.float32)
    src = str(tmp_path / "in.npz")
    np.savez(src, q=q, k=k, v=v, w=w)
    env = dict(os.environ, PYTHONPATH=REPO, GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS="1")
    worker = os.path.join(REPO, "tests", "torch_ring_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), "2", str(tmp_path / "rdv"), src,
         str(tmp_path / f"out{r}.npz")], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    outs = [np.load(str(tmp_path / f"out{r}.npz")) for r in range(2)]

    mesh = make_mesh({"sp": 2, "dp": 1, "tp": 1})
    jargs = [jnp.asarray(a) for a in (q, k, v)]
    jw = jnp.asarray(w)
    for causal in (False, True):
        ring = jring.make_ring_attention(mesh, axis="sp", causal=causal)

        def fwd_bwd(q, k, v, w):
            out, vjp = jax.vjp(ring, q, k, v)
            return (out,) + vjp(w)

        jout, *jgrads = jax.jit(fwd_bwd)(*jargs, jw)
        for impl in ("xla", "cuda"):
            key = f"{impl}_{int(causal)}"
            for name, want in zip(("out", "dq", "dk", "dv"),
                                  (jout,) + tuple(jgrads)):
                got = np.concatenate([o[f"{key}_{name}"] for o in outs],
                                     axis=1)
                np.testing.assert_allclose(got, np.asarray(want),
                                           rtol=RTOL, atol=ATOL,
                                           err_msg=f"{key} {name}")
