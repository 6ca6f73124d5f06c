"""torch-chaos-run: replay a named fault plan against a local port cluster.

The counterpart of tools/chaos_run.py for the PyTorch/CUDA port: spins
up a port master + N port worker processes (tests/torch_spawn_master.py,
tests/torch_spawn_worker.py) over a temporary (or given) db, runs the
golden pipeline twice — once clean, once under the chosen fault plan —
and reports whether the fault fired and whether the faulted run's
output is bit-exact to the clean one.

    python tools/torch_chaos_run.py --list
    python tools/torch_chaos_run.py worker-crash --device cpu
    python tools/torch_chaos_run.py memory-pressure          # on a card
    python tools/torch_chaos_run.py "pipeline.save:raise:exc=storage:n=3"

A plan name resolves via scanner_tpu_torch.util.faults.NAMED_PLANS (the
JAX package's plans); anything else is parsed as a raw plan spec
(docs/robustness.md syntax).  Plans whose sites live in the workers
(pipeline.*, storage.*, gcs.*, worker.*, memory.*, gang.*) ship to ONE
worker process via SCANNER_TPU_FAULTS, so the sibling(s) stay healthy
to absorb the reassigned work; rpc.client.* plans arm in this process
(the client), master-side ones in the master.  A crashed master is
respawned once so recovery can be observed.

Workers run on `--device` ("cuda", the default, every worker on the
current card; "cuda:N"; or "cpu").  Asking for a card without one
raises before anything starts.  memory.* plans fire in host-to-card
staging, which only a card's workers do: they need a card, and run
Histogram over a stored table of seeded 640x480 frames (pickled, as the
card's main path stores them — no video decoder needed).  gang.* plans
need two ranks on two devices: they run on the CPU only (two NCCL ranks
on one card are refused).  At the end the cluster is shut down cleanly;
each surviving worker reports its kernel launches, and the last line of
output is one JSON object: plan, fired, bit_exact, rows, the seconds of
each run, the workers' histogram launches and the processes that had to
be killed.

Exit codes: 0 = fault fired and output bit-exact; 1 = verification
failed; 2 = bad usage.
"""

import argparse
import json
import os
import shutil
import struct
import subprocess
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_DEFAULT_ROWS = 24
# memory.* plans: the stored frames' geometry (the card's main path's)
FRAME_H, FRAME_W = 480, 640


def _pk(v: int) -> bytes:
    return struct.pack("<q", v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="replay a named fault plan against a local cluster "
                    "of the PyTorch/CUDA port")
    ap.add_argument("plan", nargs="?",
                    help="named plan (see --list) or a raw plan spec")
    ap.add_argument("--list", action="store_true",
                    help="list the canned fault plans and exit")
    ap.add_argument("--db", default=None,
                    help="db path (default: a fresh temp dir, removed "
                         "at the end)")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--rows", type=int, default=N_DEFAULT_ROWS)
    ap.add_argument("--task-timeout", type=float, default=8.0,
                    help="per-task timeout for the faulted run (the "
                         "revocation safety net)")
    ap.add_argument("--device", default="cuda",
                    help="where the workers run: cuda (the current card), "
                         "cuda:N or cpu (default %(default)s)")
    args = ap.parse_args(argv)

    from scanner_tpu_torch.util import faults

    if args.list:
        width = max(len(n) for n in faults.NAMED_PLANS)
        for name, spec in sorted(faults.NAMED_PLANS.items()):
            print(f"{name:<{width}}  {spec}")
        return 0
    if not args.plan:
        ap.error("a plan name or spec is required (or --list)")

    spec = faults.NAMED_PLANS.get(args.plan, args.plan)
    rules = faults.parse_plan(spec)  # validate before spinning anything
    sites = {r.site for r in rules}
    # the workers' device, resolved here: a card that is not there
    # raises before any process starts
    from scanner_tpu_torch.engine.evaluate import resolve_device
    device = resolve_device(args.device)
    # memory.* sites hook host-to-card staging (engine/batch.py
    # staged_device_put): they need a frame pipeline with a device
    # kernel, on workers that stage — a card's
    mem_plan = any(s.split(".")[0] == "memory" for s in sites)
    if mem_plan and device.type != "cuda":
        print("torch-chaos-run: memory.* plans fire in host-to-card "
              "staging, which only a card's workers do: run them with "
              "--device cuda", file=sys.stderr)
        return 2
    # gang.* sites fire in the worker process (engine/gang.py
    # spawn_member), and a gang plan needs the bulk itself to run in
    # gang mode (PerfParams.gang_hosts) so there is a gang to lose
    gang_plan = any(s.split(".")[0] == "gang" for s in sites)
    if gang_plan and device.type == "cuda":
        print("torch-chaos-run: gang.* plans put two ranks on one "
              "device, which NCCL refuses on a card: run them with "
              "--device cpu", file=sys.stderr)
        return 2
    worker_side = any(s.split(".")[0] in ("pipeline", "storage", "gcs",
                                          "worker", "memory", "gang")
                      for s in sites)
    master_side = "rpc.server.handle" in sites
    client_side = "rpc.client.call" in sites
    print(f"plan: {spec}\nsites: {sorted(sites)} "
          f"(worker={worker_side} master={master_side} "
          f"client={client_side}) device: {device}")

    import tempfile

    import cloudpickle

    import scanner_tpu_torch  # noqa: F401 — registers builtin ops
    from scanner_tpu_torch import (CacheMode, Client, Kernel, NamedStream,
                                   PerfParams, register_op)

    @register_op(name="ChaosRunDouble")
    class ChaosRunDouble(Kernel):
        def execute(self, x: bytes) -> bytes:
            time.sleep(0.1)
            return _pk(2 * struct.unpack("<q", x)[0])

    cloudpickle.register_pickle_by_value(sys.modules[__name__])

    # the workers' launch counts and the default db live in one temp
    # dir, removed once the counts are read
    scratch = tempfile.mkdtemp(prefix="chaos_run_")
    db_path = args.db or os.path.join(scratch, "db")
    counts_dir = os.path.join(scratch, "counts")
    os.makedirs(counts_dir)
    print(f"db: {db_path}")
    # the seed client only writes the input table (two clients on one
    # database keep their own metadata: it is written before the master
    # starts); it computes nothing, so it runs on the CPU
    seed = Client(db_path=db_path, device="cpu")
    if mem_plan:
        import numpy as np

        import scanner_tpu_torch.kernels  # noqa: F401 — Histogram
        frames = np.random.RandomState(0).randint(
            0, 256, (args.rows, FRAME_H, FRAME_W, 3)).astype(np.uint8)
        seed.new_table("chaos_frames", ["frame"], [[f] for f in frames],
                       codecs={"frame": "pickle"}, overwrite=True)
    else:
        seed.new_table("chaos_src", ["output"],
                       [[_pk(100 + i)] for i in range(args.rows)],
                       overwrite=True)
    seed.stop()

    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("SCANNER_TPU_FAULTS", None)
    if gang_plan:
        # bounded rendezvous + a short formation hold so the drill's
        # re-form-on-survivors path resolves in seconds, not minutes
        env.setdefault("SCANNER_TPU_GANG_INIT_TIMEOUT", "30")
        env.setdefault("SCANNER_TPU_GANG_FORM_TIMEOUT", "6")

    def spawn(script, argv, plan=None, env_extra=None):
        e = dict(env)
        if plan:
            e["SCANNER_TPU_FAULTS"] = plan
        e.update(env_extra or {})
        return subprocess.Popen([sys.executable,
                                 os.path.join(REPO, "tests",
                                              f"torch_{script}"),
                                 *argv], env=e)

    import socket

    def _free_port() -> int:
        with socket.socket() as s:
            s.bind(("localhost", 0))
            return s.getsockname()[1]

    # the sharded-control-plane drill: three master shards instead of
    # one (docs/robustness.md §Sharded control plane).  The plan arms
    # in EVERY shard, but only the shard owning the bulk handles
    # FinishedWork — so exactly that shard dies, and the respawn (no
    # plan) fails the partition over in its shard namespace.
    shard_loss = args.plan == "master-shard-loss"
    num_shards = 3 if shard_loss else 1
    if shard_loss:
        env["SCANNER_TPU_CONTROL_SHARDS"] = str(num_shards)
    shard_ports = [_free_port() for _ in range(num_shards)]
    port = shard_ports[0]
    addr = f"localhost:{port}"

    procs = []
    shard_masters = {}
    for sid, p in enumerate(shard_ports):
        argv = [db_path, str(p)]
        if shard_loss:
            argv += [str(sid), str(num_shards)]
        m = spawn("spawn_master.py", argv,
                  plan=spec if master_side else None)
        shard_masters[sid] = m
        procs.append(m)
    master = shard_masters[0]
    workers = []
    for i in range(args.workers):
        # the FIRST worker carries a worker-side plan; siblings stay
        # healthy so reassigned work has somewhere to go
        w = spawn("spawn_worker.py",
                  [addr, db_path, "--device", str(device), "--counts-out",
                   os.path.join(counts_dir, f"worker{i}.json")],
                  plan=spec if worker_side and i == 0 else None)
        workers.append(w)
        procs.append(w)

    respawned = {}
    if master_side and shard_loss:
        # per-shard crash watch: whichever shard the fault kills is
        # respawned under the SAME shard id + port, with no plan —
        # the respawn CAS-claims its shard's next generation and
        # replays its journal (shard failover)
        def watch_shard(sid: int):
            rc_ = shard_masters[sid].wait()
            if rc_ != faults.CRASH_EXIT_CODE:
                return
            respawned["rc"] = rc_
            respawned["shard"] = sid
            print(f"shard {sid} died (exit {rc_}); respawning")
            time.sleep(0.5)
            m2 = spawn("spawn_master.py",
                       [db_path, str(shard_ports[sid]), str(sid),
                        str(num_shards)])
            shard_masters[sid] = m2
            procs.append(m2)
        for sid in shard_masters:
            threading.Thread(target=watch_shard, args=(sid,),
                             daemon=True).start()
    elif master_side:
        def respawn_master():
            respawned["rc"] = master.wait()
            print(f"master died (exit {respawned['rc']}); respawning")
            time.sleep(0.5)
            m2 = spawn("spawn_master.py", [db_path, str(port)])
            respawned["proc"] = m2
            procs.append(m2)
        threading.Thread(target=respawn_master, daemon=True).start()

    from scanner_tpu_torch.engine.rpc import wait_for_server
    from scanner_tpu_torch.engine.service import MASTER_SERVICE
    wait_for_server(addr, MASTER_SERVICE, timeout=60.0)
    for p in shard_ports[1:]:
        # every shard must serve before the client resolves the map,
        # or the drill's routing would collapse onto the seed shard
        wait_for_server(f"localhost:{p}", MASTER_SERVICE, timeout=60.0)
    sc = Client(db_path=db_path, master=addr)
    # wait for every worker to register (subprocess import time
    # dominates); a worker-side plan can only fire on a joined worker
    deadline = time.time() + 60.0
    while time.time() < deadline:
        st = sc.job_status()
        if st.get("num_workers", 0) >= args.workers:
            break
        time.sleep(0.25)
    print(f"workers registered: {sc.job_status().get('num_workers', 0)}")

    seconds = {}

    def run(out_name, **kw):
        t0 = time.time()
        if mem_plan:
            col = sc.io.Input([NamedStream(sc, "chaos_frames")])
            col = sc.ops.Histogram(frame=col)
        else:
            col = sc.io.Input([NamedStream(sc, "chaos_src")])
            col = sc.ops.ChaosRunDouble(x=col)
        out = NamedStream(sc, out_name)
        if gang_plan:
            # gang mode: ~2 big tasks instead of rows/2 small ones —
            # each task costs a member-runner rendezvous, and two is
            # enough to prove loss + re-form + completion.  io must be
            # a work-packet multiple, so round rows/2 down to one
            # (floored at a single packet) for any --rows value.
            wp = 4
            io = max(wp, (args.rows // 2 // wp) * wp)
            perf = PerfParams.manual(wp, io, gang_hosts=2, **kw)
        else:
            perf = PerfParams.manual(2, 2, **kw)
        sc.run(sc.io.Output(col, [out]), perf,
               cache_mode=CacheMode.Overwrite, show_progress=True)
        seconds[out_name] = time.time() - t0
        return [_row_bytes(r) for r in out.load()]

    # the master-failover drill leans on the write-ahead journal as
    # the ONLY durability (checkpoint_frequency=0) and adds a
    # stale-master fencing probe after the runs
    failover = args.plan == "master-failover"

    rc = 1
    summary = {"plan": args.plan, "spec": spec, "device": str(device)}
    try:
        # faulted run FIRST: worker/master-side plans armed via env are
        # live from process start, so running clean before them would
        # inject into the "clean" baseline.  After the faulted run the
        # victim is dead/deactivated or its fire budget is spent, and
        # the clean run sees an undisturbed cluster.
        if client_side:
            faults.install(spec)
        print("== faulted run ==")
        got = run("chaos_faulted", task_timeout=args.task_timeout,
                  checkpoint_frequency=0 if (failover or shard_loss)
                  else 1)
        # read the rule counters BEFORE clear() empties the registry —
        # client-side fires exist nowhere else (sc.metrics() aggregates
        # master+workers, not this process)
        local_fired = faults.fired()
        faults.clear()
        if shard_loss:
            # the plan is still ARMED in every surviving shard (each
            # process carries its own fire budget), so a clean bulk
            # that happened to hash onto an armed shard would crash it
            # too: replace the survivors with unarmed processes first.
            # (The victim's respawn is already unarmed.)
            time.sleep(1.0)  # let the crash watcher finish its respawn
            for sid, m_ in list(shard_masters.items()):
                if sid == respawned.get("shard"):
                    continue
                m_.kill()
                m_.wait()
                m2 = spawn("spawn_master.py",
                           [db_path, str(shard_ports[sid]), str(sid),
                            str(num_shards)])
                shard_masters[sid] = m2
                procs.append(m2)
            for p_ in shard_ports:
                wait_for_server(f"localhost:{p_}", MASTER_SERVICE,
                                timeout=60.0)
        print("== clean run ==")
        golden = run("chaos_clean", task_timeout=args.task_timeout)

        exact = got == golden
        # remote fires show up as worker/master death or in the
        # cluster-wide metric when the process is still alive
        snap = sc.metrics()
        entry = snap.get("scanner_tpu_faults_injected_total", {})
        cluster_fired = sum(s.get("value", 0)
                            for s in entry.get("samples", []))
        crashed = [p for p in procs
                   if p.poll() == faults.CRASH_EXIT_CODE]
        # a preempted worker drains and exits 0 BEFORE the metric poll,
        # taking its own faults counter with it — the master-side
        # preemption-notice counter is the surviving evidence
        preempt_notices = sum(
            s.get("value", 0) for s in snap.get(
                "scanner_tpu_worker_preempt_notices_total",
                {}).get("samples", []))
        print(f"\nfault fired: local={int(local_fired)} "
              f"cluster-metric={int(cluster_fired)} "
              f"injected-crashes={len(crashed)} "
              f"preempt-notices={int(preempt_notices)}")
        print(f"output bit-exact to clean run: {exact} "
              f"({len(got)} rows)")
        fired = bool(local_fired or cluster_fired or crashed
                     or preempt_notices
                     or respawned.get("rc") == faults.CRASH_EXIT_CODE)
        extra_ok = True
        if gang_plan:
            # gang-drill evidence (the drill's acceptance): the gang aborted
            # on the injected host loss, RE-FORMED at a higher epoch on
            # the survivors, and no survivor ate a blacklist strike
            def _tot(name):
                return sum(s.get("value", 0) for s in
                           snap.get(name, {}).get("samples", []))

            formed = _tot("scanner_tpu_gang_formed_total")
            aborted = _tot("scanner_tpu_gang_aborted_total")
            reforms = _tot("scanner_tpu_gang_reforms_total")
            epoch = _tot("scanner_tpu_gang_epoch")
            strikes = _tot("scanner_tpu_blacklist_strikes_total")
            print(f"gang: formed={int(formed)} aborted={int(aborted)} "
                  f"reforms={int(reforms)} epoch={int(epoch)} "
                  f"strikes={int(strikes)}")
            # sharded-path evidence: gang_sharded defaults on, so the
            # drill's tasks evaluate mesh-partitioned — every shard
            # commit the master folded must agree ("ok"); any mismatch
            # or partial fold under member loss is a real divergence
            folds = snap.get("scanner_tpu_gang_shard_commit_folds_total",
                             {}).get("samples", [])
            fold_ok = sum(s.get("value", 0) for s in folds
                          if s.get("labels", {}).get("result") == "ok")
            fold_bad = sum(s.get("value", 0) for s in folds
                           if s.get("labels", {}).get("result") != "ok")
            shard_rows = _tot("scanner_tpu_gang_shard_rows_total")
            if shard_rows or folds:
                print(f"gang shard: rows={int(shard_rows)} "
                      f"folds ok={int(fold_ok)} non-ok={int(fold_bad)}")
            extra_ok = bool(aborted >= 1 and reforms >= 1
                            and epoch >= 2 and strikes == 0
                            and fold_bad == 0)
        if shard_loss:
            # shard-loss evidence (the drill's acceptance): the killed
            # shard's respawn replayed its journal (failover replay >
            # 0) with ZERO journaled completions re-queued, no worker
            # ate a blacklist strike, and no shard's health roll-up is
            # left unhealthy (the survivors never were; the victim's
            # respawn recovered)
            def _tot(name):
                return sum(s.get("value", 0) for s in
                           snap.get(name, {}).get("samples", []))

            replayed = _tot("scanner_tpu_journal_replayed_records_total")
            failovers = _tot("scanner_tpu_shard_failovers_total")
            reexec = _tot("scanner_tpu_shard_journal_reexec_total")
            strikes = _tot("scanner_tpu_blacklist_strikes_total")
            from scanner_tpu_torch.engine.rpc import RpcClient
            statuses = {}
            for sid, p_ in enumerate(shard_ports):
                probe = RpcClient(f"localhost:{p_}", MASTER_SERVICE,
                                  timeout=10.0)
                try:
                    h = probe.try_call("GetHealth", workers=False,
                                       timeout=10.0)
                finally:
                    probe.close()
                statuses[sid] = (h or {}).get("status")
            print(f"shard-loss: killed-shard={respawned.get('shard')} "
                  f"journal-replayed={int(replayed)} "
                  f"failovers={int(failovers)} reexec={int(reexec)} "
                  f"strikes={int(strikes)} shard-health={statuses}")
            extra_ok = bool(
                replayed > 0 and failovers >= 1 and reexec == 0
                and strikes == 0
                and respawned.get("rc") == faults.CRASH_EXIT_CODE
                and all(st is not None and st != "unhealthy"
                        for st in statuses.values()))
        if failover:
            # failover-specific evidence: the successor replayed the
            # journal, zero blacklist strikes anywhere, and a
            # forced-stale (generation-1) master is fenced with zero
            # accepted mutations
            def _tot(name):
                return sum(s.get("value", 0) for s in
                           snap.get(name, {}).get("samples", []))

            replayed = _tot("scanner_tpu_journal_replayed_records_total")
            strikes = _tot("scanner_tpu_blacklist_strikes_total")
            with socket.socket() as s2:
                s2.bind(("localhost", 0))
                port2 = s2.getsockname()[1]
            stale = spawn("spawn_master.py", [db_path, str(port2)],
                          env_extra={"SCANNER_TPU_MASTER_GENERATION":
                                     "1"})
            procs.append(stale)
            from scanner_tpu_torch.engine.rpc import RpcClient
            wait_for_server(f"localhost:{port2}", MASTER_SERVICE,
                            timeout=60.0)
            probe = RpcClient(f"localhost:{port2}", MASTER_SERVICE,
                              timeout=10.0)
            try:
                fenced = all(
                    probe.call(m, **p).get("fenced")
                    for m, p in (
                        ("NewJob", {"spec": b"", "token": "t"}),
                        ("NextWork", {"worker_id": 0, "bulk_id": 0}),
                        ("FinishedWork", {"worker_id": 0, "bulk_id": 0,
                                          "job_idx": 0, "task_idx": 0,
                                          "attempt": 0})))
            finally:
                probe.close()
            print(f"failover: journal-replayed={int(replayed)} "
                  f"strikes={int(strikes)} stale-master-fenced={fenced}")
            extra_ok = bool(replayed > 0 and strikes == 0 and fenced)
        rc = 0 if (exact and fired and extra_ok) else 1
        if not fired:
            print("WARNING: no evidence the fault fired — plan matched "
                  "nothing?")
        summary.update(fired=fired, bit_exact=exact, rows=len(got),
                       extra_ok=extra_ok,
                       faulted_s=seconds.get("chaos_faulted"),
                       clean_s=seconds.get("chaos_clean"))
    finally:
        # a clean stop: Shutdown reaches the master and every live
        # worker, whose blocking waits return (each worker then writes
        # its launch counts); what is still alive after that is killed
        # and counted
        try:
            sc.shutdown_cluster()
        except Exception as e:  # noqa: BLE001 — the master may be dead
            print(f"shutdown_cluster: {e}")
        sc.stop()
        deadline = time.time() + 30.0
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.time(), 0.1))
            except subprocess.TimeoutExpired:
                pass
        killed = 0
        for p in procs:
            if p.poll() is None:
                killed += 1
                p.kill()
                p.wait()
        launches = 0
        for i in range(len(workers)):
            path = os.path.join(counts_dir, f"worker{i}.json")
            if os.path.exists(path):
                with open(path) as f:
                    launches += json.load(f)["histogram_launches"]
        shutil.rmtree(scratch, ignore_errors=True)
        summary.update(worker_histogram_launches=launches, killed=killed,
                       processes=len(procs), rc=rc)
        print(json.dumps(summary))
    return rc


def _row_bytes(r) -> bytes:
    """A loaded row as bytes: the sink's bytes as they are, an array's
    (Histogram's (C, bins) counts) dtype, shape and buffer."""
    if isinstance(r, (bytes, bytearray, memoryview)):
        return bytes(r)
    import numpy as np
    a = np.ascontiguousarray(r)
    return f"{a.dtype}{a.shape}".encode() + a.tobytes()


if __name__ == "__main__":
    sys.exit(main())
