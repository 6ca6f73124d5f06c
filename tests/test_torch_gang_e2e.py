"""Gang bulks end to end: a port Master and two port Workers with
device="cpu" over gRPC on localhost run `gang_hosts=2` bulks whose
members are real child processes (python -m
scanner_tpu_torch.engine.gang) joined in one gloo group.  Their stored
rows must equal a JAX local Client run of the same graph on the same
table:
  * sharded over uneven rows (each member evaluates only its shard);
  * replicated (`[gang] sharded=false` on the master);
  * config 2's Histogram -> HistogramDelta over a synthesized clip with
    the halo exchange on (the boundary frame moves between members:
    `halo_bytes > 0` in the shard stats);
  * a drill: one member's run fails once (a parent-side
    gang.collective fault), the gang aborts and re-forms at a higher
    epoch with zero strikes and the same rows.
No member child outlives its bulk.  Host loss by SIGKILL (a spawned
cluster, and the bare group re-forming on the same port) is marked
slow, as in the JAX package.
"""

import os
import signal
import socket
import struct
import subprocess
import sys
import time

import cloudpickle
import numpy as np
import pytest

import scanner_tpu as sj
import scanner_tpu.kernels  # noqa: F401
from scanner_tpu import video as scv

import scanner_tpu_torch as st
import scanner_tpu_torch.kernels  # noqa: F401
from scanner_tpu_torch.engine import gang as tgang
from scanner_tpu_torch.engine.service import MASTER_SERVICE, Master, Worker
from scanner_tpu_torch.util import faults as tfaults
from scanner_tpu_torch.util import metrics as tmx
from torch_model_checks import stop_process_engine  # noqa: F401

cloudpickle.register_pickle_by_value(sys.modules[__name__])

pytestmark = pytest.mark.chaos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS, N_FRAMES = 10, 16


def _pk(v: int) -> bytes:
    return struct.pack("<q", v)


@st.register_op(name="TorchGangE2EDouble")
class _TDouble(st.Kernel):
    def execute(self, x: bytes) -> bytes:
        return _pk(2 * struct.unpack("<q", x)[0])


@sj.register_op(name="TorchGangE2EDouble")
class _JDouble(sj.Kernel):
    def execute(self, x: bytes) -> bytes:
        return _pk(2 * struct.unpack("<q", x)[0])


def _counter(name: str, **labels) -> float:
    entry = tmx.registry().snapshot().get(name, {})
    return sum(s["value"] for s in entry.get("samples", [])
               if all(s["labels"].get(k) == v for k, v in labels.items()))


def _member_children():
    """Live gang member runners started by this process."""
    me, out = os.getpid(), []
    for pid in os.listdir("/proc"):
        if not pid.isdigit():
            continue
        try:
            with open(f"/proc/{pid}/stat") as fh:
                ppid = int(fh.read().rsplit(")", 1)[1].split()[1])
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                cmd = fh.read()
        except (OSError, ValueError, IndexError):
            continue
        if ppid == me and b"scanner_tpu_torch.engine.gang" in cmd:
            out.append(int(pid))
    return out


def _graph(sc, pkg, kind, out):
    if kind == "double":
        col = sc.ops.TorchGangE2EDouble(
            x=sc.io.Input([pkg.NamedStream(sc, "src")]))
    else:
        col = sc.ops.HistogramDelta(hist=sc.ops.Histogram(
            frame=sc.io.Input([pkg.NamedVideoStream(sc, "clip")])))
    return sc.io.Output(col, [pkg.NamedStream(sc, out)])


def _stored(db, table):
    desc = db.table_descriptor(table)
    return list(db.load_column(table, desc.columns[0].name))


@pytest.fixture(scope="module")
def gang_cluster(tmp_path_factory):
    """The JAX reference rows of both graphs (a local JAX Client), and a
    port master with two CPU workers over a copy of the same tables."""
    root = tmp_path_factory.mktemp("gang_e2e")
    clip = str(root / "clip.mp4")
    scv.synthesize_video(clip, num_frames=N_FRAMES, width=32, height=24,
                         fps=24, keyint=8)
    src = [[_pk(100 + i)] for i in range(N_ROWS)]
    jc = sj.Client(db_path=str(root / "jdb"))
    jc.new_table("src", ["output"], src)
    assert not jc.ingest_videos([("clip", clip)])[1]
    want = {}
    for kind, io in (("double", 5), ("config2", N_FRAMES)):
        jc.run(_graph(jc, sj, kind, f"want_{kind}"),
               sj.PerfParams.manual(1, io), show_progress=False,
               cache_mode=sj.CacheMode.Overwrite)
        want[kind] = _stored(jc._db, f"want_{kind}")
    jc.stop()
    db_path = str(root / "tdb")
    seed = st.Client(db_path=db_path, device="cpu")
    seed.new_table("src", ["output"], src)
    assert not seed.ingest_videos([("clip", clip)])[1]
    seed.stop()
    old = (tgang.form_timeout_s(), tgang.sharded_enabled())
    tgang.set_form_timeout_s(30.0)
    m = Master(db_path=db_path, no_workers_timeout=60.0)
    addr = f"localhost:{m.port}"
    workers = [Worker(addr, db_path=db_path, device="cpu")
               for _ in range(2)]
    sc = st.Client(db_path=db_path, master=addr)
    yield {"client": sc, "master": m, "want": want}
    tfaults.clear()
    sc.stop()
    for w in workers:
        w.stop()
    m.stop()
    tgang.set_form_timeout_s(old[0])
    tgang.set_sharded(old[1])


def _run_gang(g, kind, out, io, sharded=True):
    sc, m = g["client"], g["master"]
    tgang.set_sharded(sharded)
    series = ("scanner_tpu_gang_shard_rows_total",
              "scanner_tpu_gang_shard_decode_rows_total",
              "scanner_tpu_gang_shard_halo_bytes_total",
              "scanner_tpu_blacklist_strikes_total",
              "scanner_tpu_gang_reforms_total",
              "scanner_tpu_gang_aborted_total")
    before = {k: _counter(k) for k in series}
    sc.run(_graph(sc, st, kind, out),
           st.PerfParams.manual(1, io, gang_hosts=2), show_progress=False,
           cache_mode=st.CacheMode.Overwrite)
    rows = _stored(sc._db, out)
    s = sc.job_status()
    assert s["finished"] and s["failed_jobs"] == [], s
    assert _member_children() == []
    with m._lock:
        epoch = m._bulk.gang_epoch
    return rows, {k: _counter(k) - before[k] for k in series}, epoch


def test_sharded_uneven_rows_equal_jax(gang_cluster):
    """io=5 over two members: 3 + 2 rows a task."""
    rows, d, epoch = _run_gang(gang_cluster, "double", "sharded", 5)
    assert rows == gang_cluster["want"]["double"]
    assert d["scanner_tpu_gang_shard_rows_total"] == N_ROWS
    assert d["scanner_tpu_gang_shard_decode_rows_total"] == N_ROWS
    assert d["scanner_tpu_blacklist_strikes_total"] == 0
    assert epoch == 2  # two tasks, one gang each, no abort


def test_replicated_rows_equal_jax(gang_cluster):
    rows, d, _ = _run_gang(gang_cluster, "double", "replicated", 10,
                           sharded=False)
    assert rows == gang_cluster["want"]["double"]
    assert d["scanner_tpu_gang_shard_rows_total"] == 0


def test_slow_member_teardown_keeps_its_result(gang_cluster, monkeypatch):
    """Member 1 outlives its gang's commit: its runner sleeps after it
    wrote its result (a child-side gang.teardown delay), member 0
    commits, and the master retires the gang from the liveness list
    that the heartbeat carries while the bulk's second task waits.  The
    finished member is not reaped as aborted: all four member runs
    report ok, nothing is aborted or struck, and the slow runners exit
    on their own."""
    results = []
    spawn = tgang.spawn_member

    def recording(request, **kw):
        res = spawn(request, **kw)
        results.append((request["process_id"], res.get("ok"),
                        res.get("stage"), time.time(),
                        res["phases"]["teardown"]))
        return res

    monkeypatch.setattr(tgang, "spawn_member", recording)
    monkeypatch.setenv("SCANNER_TPU_GANG_CHILD_FAULTS",
                       "gang.teardown:delay:seconds=4:match=m1")
    sc = gang_cluster["client"]
    tgang.set_sharded(False)
    series = ("scanner_tpu_gang_aborted_total",
              "scanner_tpu_blacklist_strikes_total")
    before = {k: _counter(k) for k in series}
    sc.run(_graph(sc, st, "double", "slow_teardown"),
           st.PerfParams.manual(1, 5, gang_hosts=2), show_progress=False,
           cache_mode=st.CacheMode.Overwrite)
    committed = time.time()
    deadline = committed + 30
    while len(results) < 4 and time.time() < deadline:
        time.sleep(0.05)
    assert _stored(sc._db, "slow_teardown") == gang_cluster["want"]["double"]
    assert sorted(r[:3] for r in results) \
        == [(0, True, None)] * 2 + [(1, True, None)] * 2, results
    # member 1 was still tearing down when the job finished, and each
    # of its runs took the delay between its result and its exit
    assert max(r[3] for r in results if r[0] == 1) > committed
    assert min(r[4] for r in results if r[0] == 1) >= 4.0
    assert {k: _counter(k) - before[k] for k in series} \
        == {k: 0 for k in series}
    assert _member_children() == []


def test_halo_exchange_config2_rows_equal_jax(gang_cluster):
    """Histogram -> HistogramDelta needs the frame before each shard:
    member 1 receives it from member 0 over the halo exchange instead
    of decoding it."""
    rows, d, _ = _run_gang(gang_cluster, "config2", "halo", N_FRAMES)
    assert len(rows) == N_FRAMES
    assert rows == gang_cluster["want"]["config2"]
    assert d["scanner_tpu_gang_shard_halo_bytes_total"] == 32 * 24 * 3
    assert d["scanner_tpu_gang_shard_decode_rows_total"] == N_FRAMES


def test_member_failure_reforms_at_higher_epoch(gang_cluster):
    tfaults.install("gang.collective:raise:n=1:times=1")
    try:
        rows, d, epoch = _run_gang(gang_cluster, "double", "drill", 10)
        assert tfaults.fired("gang.collective") == 1
    finally:
        tfaults.clear()
    assert rows == gang_cluster["want"]["double"]
    assert d["scanner_tpu_gang_aborted_total"] >= 1
    assert d["scanner_tpu_gang_reforms_total"] >= 1
    assert d["scanner_tpu_blacklist_strikes_total"] == 0
    assert epoch >= 3  # formed, aborted (bump), re-formed


# ---------------------------------------------------------------------------
# host loss by SIGKILL (slow)
# ---------------------------------------------------------------------------

NODE = """
import sys
from scanner_tpu_torch.engine import service
if sys.argv[1] == "master":
    m = service.Master(db_path=sys.argv[2], port=int(sys.argv[3]))
    m.wait_for_shutdown()
else:
    service.start_worker(sys.argv[2], db_path=sys.argv[3], block=True,
                         device="cpu")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_gang_e2e_host_loss_reforms_bit_exact(tmp_path):
    """A spawned port master + 2 workers run a gang bulk; worker 0 dies
    the moment its first member enters the collective (the
    gang-host-loss plan; its runner dies with it by PR_SET_PDEATHSIG).
    The gang re-forms on the survivor at a higher epoch, bit-exact, with
    zero blacklist strikes."""
    from scanner_tpu_torch.engine.rpc import wait_for_server
    db_path = str(tmp_path / "db")
    seed = st.Client(db_path=db_path, device="cpu")
    seed.new_table("src", ["output"], [[_pk(100 + i)] for i in range(8)])
    seed.stop()
    env = dict(os.environ, PYTHONPATH=REPO,
               SCANNER_TPU_GANG_INIT_TIMEOUT="30",
               SCANNER_TPU_GANG_FORM_TIMEOUT="6")
    env.pop("SCANNER_TPU_FAULTS", None)
    port = _free_port()
    addr = f"localhost:{port}"

    def spawn(argv, plan=None):
        e = dict(env)
        if plan:
            e["SCANNER_TPU_FAULTS"] = plan
        return subprocess.Popen([sys.executable, "-c", NODE, *argv], env=e)

    procs = [spawn(["master", db_path, str(port)])]
    procs.append(spawn(["worker", addr, db_path],
                       plan=tfaults.NAMED_PLANS["gang-host-loss"]))
    procs.append(spawn(["worker", addr, db_path]))
    sc = None
    try:
        wait_for_server(addr, MASTER_SERVICE, timeout=60.0)
        sc = st.Client(db_path=db_path, master=addr)
        deadline = time.time() + 60
        while time.time() < deadline \
                and sc.job_status().get("num_workers", 0) < 2:
            time.sleep(0.25)
        out = st.NamedStream(sc, "gang_out")
        sc.run(sc.io.Output(sc.ops.TorchGangE2EDouble(
            x=sc.io.Input([st.NamedStream(sc, "src")])), [out]),
            st.PerfParams.manual(4, 4, gang_hosts=2),
            cache_mode=st.CacheMode.Overwrite, show_progress=False)
        assert [bytes(r) for r in out.load()] == \
            [_pk(2 * (100 + i)) for i in range(8)]
        time.sleep(0.5)
        assert [p for p in procs if p.poll() == tfaults.CRASH_EXIT_CODE]
        snap = sc.metrics()

        def tot(name):
            return sum(s.get("value", 0) for s in
                       snap.get(name, {}).get("samples", []))

        assert tot("scanner_tpu_gang_aborted_total") >= 1
        assert tot("scanner_tpu_gang_reforms_total") >= 1
        assert tot("scanner_tpu_gang_epoch") >= 2
        assert tot("scanner_tpu_blacklist_strikes_total") == 0
    finally:
        if sc is not None:
            sc.stop()
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


RANK = """
import sys, time
import numpy as np
from scanner_tpu_torch.engine import gang
from scanner_tpu_torch.parallel import distributed as dist
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
dist.initialize(dist.CoordinatorConfig(f"127.0.0.1:{port}", world, rank),
                init_timeout=15)
print("JOINED", flush=True)
if rank == 1:
    time.sleep(600)  # killed mid-collective by the test
total = gang._collective_digest_sum(world, rank, 7)
print("TOTAL", total, flush=True)
dist.shutdown()
"""


@pytest.mark.slow
def test_sigkill_then_reform_same_port():
    """SIGKILL one rank after it joined the group: the survivor's
    collective fails within the group's timeout instead of hanging on
    gloo's default; then a fresh one-rank group binds the SAME store
    port and completes (what a re-formed gang epoch does)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(r), "2",
                               str(port)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        for line in procs[1].stdout:  # past the store's warnings
            if line.strip() == "JOINED":
                break
        else:
            raise AssertionError("rank 1 never joined")
        os.kill(procs[1].pid, signal.SIGKILL)
        out0 = procs[0].communicate(timeout=120)[0]
        assert procs[0].returncode != 0 and "TOTAL" not in out0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    again = subprocess.run([sys.executable, "-c", RANK, "0", "1",
                            str(port)], env=env, capture_output=True,
                           text=True, timeout=120)
    assert again.returncode == 0, again.stdout + again.stderr
    assert "TOTAL 7" in again.stdout
