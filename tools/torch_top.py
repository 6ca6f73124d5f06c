"""torch-top: live telemetry of a port cluster in a terminal.

The counterpart of tools/scanner_top.py for a cluster of the PyTorch/
CUDA port: it polls the port master's GetJobStatus + GetMetrics (+
GetHealth, GetShardMap) RPCs through scanner_tpu_torch.engine.rpc and
renders a per-job / per-node / per-card table.  The port keeps the JAX
package's series names (docs/observability.md), so the table, the flags,
the exit codes and the --json document are scanner_top's; a card shows
as its torch device label (`cuda:0`), and the XCACHE column reads `-`
(the port's compiles are nvcc builds and CUDA-graph captures, with no
persistent cache to hit).

    python tools/torch_top.py --master localhost:5000
    python tools/torch_top.py --master localhost:5000 --once   # scripts
    python tools/torch_top.py --master localhost:5000 --json   # machines

Rates (decode fps, eval rows/s, h2d MB/s) come from counter deltas
between polls; the first poll (and --once) uses since-process-start
averages via scanner_tpu_process_start_time_seconds.  Exit codes:
0 ok, 2 master unreachable.
"""

import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


# -- snapshot digestion -----------------------------------------------------

def _sum_counter(snap: dict, name: str, node: str) -> float:
    """Sum a counter's samples for one node across its other labels."""
    entry = snap.get(name)
    if not entry:
        return 0.0
    return sum(s.get("value", 0.0) for s in entry["samples"]
               if s["labels"].get("node") == node)


def _gauge(snap: dict, name: str, node: str, **labels) -> float:
    entry = snap.get(name)
    if not entry:
        return 0.0
    for s in entry["samples"]:
        sl = s["labels"]
        if sl.get("node") == node and all(sl.get(k) == v
                                          for k, v in labels.items()):
            return s.get("value", 0.0)
    return 0.0


def _nodes(snap: dict):
    seen = []
    for entry in snap.values():
        for s in entry["samples"]:
            n = s["labels"].get("node")
            if n and n not in seen:
                seen.append(n)
    return sorted(seen)


# -- sharded control plane fan-in -------------------------------------------

def _resolve_shards(client):
    """{shard_id: address} from GetShardMap on the dialed master, or
    None for a single-master cluster (docs/robustness.md §Sharded
    control plane).  Every shard serves the full versioned map, so the
    --master address may name any live shard."""
    reply = client.try_call("GetShardMap", retries=1)
    if not reply or int(reply.get("num_shards", 1) or 1) <= 1:
        return None
    shards = {int(k): v for k, v in (reply.get("shards") or {}).items()}
    return shards or None


def _poll_sharded(shard_clients: dict):
    """Fan GetMetrics/GetJobStatus/GetHealth across every shard.

    Mirrors ClusterClient's fan-in: each shard's master samples relabel
    to shard<k> before merging (per-shard control-plane series stay
    distinguishable in the NODE table), workers ride the lowest live
    shard only (every shard sees the same fleet — M pulls would skew
    the merged counters M-fold), and health folds worst-of via
    health.merge_status so one degraded shard degrades the roll-up.

    Returns (merged_snapshot | None, status, health, shard_rows) —
    snapshot None when no shard answered at all.
    """
    from scanner_tpu_torch.util.health import merge_status
    from scanner_tpu_torch.util.metrics import merge_snapshots

    sids = sorted(shard_clients)
    primary = sids[0]
    by_node, rows, status, healths = {}, [], None, {}
    for sid in sids:
        c = shard_clients[sid]
        node = f"shard{sid}"
        reply = c.try_call("GetMetrics", retries=1, timeout=30.0,
                           workers=(sid == primary))
        row = {"shard": sid, "addr": c.address, "up": reply is not None}
        if reply and "snapshot" in reply:
            snap = reply["snapshot"]
            for entry in snap.values():
                for s in entry.get("samples", []):
                    lb = s.get("labels") or {}
                    if lb.get("node") == "master":
                        s["labels"] = dict(lb, node=node)
            by_node[node] = snap
            row["map_epoch"] = _gauge(
                snap, "scanner_tpu_shard_map_epoch", node)
            row["failovers"] = _sum_counter(
                snap, "scanner_tpu_shard_failovers_total", node)
            row["stale_map_rejections"] = _sum_counter(
                snap, "scanner_tpu_shard_stale_map_rejections_total", node)
            row["rpcs_coalesced"] = _sum_counter(
                snap, "scanner_tpu_rpc_coalesced_total", node)
        # the bulk lives on exactly one shard: first shard that knows a
        # live bulk wins (the rest answer "no active bulk")
        st = c.try_call("GetJobStatus", bulk_id=None, retries=0)
        if status is None and st and "tasks_done" in st:
            status = st
        h = c.try_call("GetHealth", retries=0, workers=(sid == primary))
        healths[node] = h if h else {
            "status": "unhealthy", "reasons": ["shard_unreachable"],
            "firing": []}
        rows.append(row)
    health = merge_status(healths)
    return (merge_snapshots(by_node) if by_node else None,
            status, health, rows)


NODE_COUNTERS = {
    "decode_f": "scanner_tpu_decoded_frames_total",
    "eval_r": "scanner_tpu_op_rows_total",
    "h2d_b": "scanner_tpu_h2d_bytes_total",
    "d2h_b": "scanner_tpu_d2h_bytes_total",
    "retries": "scanner_tpu_retry_attempts_total",
}


def _sum_by_label(snap: dict, name: str, node: str, label: str) -> dict:
    """{label_value: summed value} for one node's samples of a series."""
    entry = snap.get(name)
    if not entry:
        return {}
    out = {}
    for s in entry["samples"]:
        sl = s["labels"]
        if sl.get("node") == node and label in sl:
            out[sl[label]] = out.get(sl[label], 0.0) + s.get("value", 0.0)
    return out


def _op_efficiency(snap: dict, node: str) -> dict:
    """{(op, device): row} from the coststats efficiency gauges,
    keeping the largest bucket per (op, device) — the steady-state
    rung (tail buckets run rarely and noisy)."""
    out = {}
    entry = snap.get("scanner_tpu_op_efficiency_ratio")
    if not entry:
        return out
    for s in entry["samples"]:
        sl = s["labels"]
        if sl.get("node") != node:
            continue
        key = (sl.get("op", "?"), sl.get("device", "?"))
        try:
            bucket = int(sl.get("bucket", 0))
        except ValueError:
            bucket = 0
        if key in out and out[key]["bucket"] >= bucket:
            continue
        labels = {"op": key[0], "device": key[1],
                  "bucket": sl.get("bucket", "0")}
        out[key] = {
            "bucket": bucket,
            "efficiency": s.get("value", 0.0),
            "compute_bound": _gauge(
                snap, "scanner_tpu_op_compute_bound", node,
                **labels) >= 0.5,
            "flops_per_s": _gauge(
                snap, "scanner_tpu_op_achieved_flops", node, **labels),
            "bytes_per_s": _gauge(
                snap, "scanner_tpu_op_achieved_bandwidth_bytes", node,
                **labels),
        }
    return out


def _per_device(snap: dict, name: str, node: str) -> dict:
    """{device: value} for one node's samples of a device-labeled
    series (multi-chip evaluator affinity)."""
    entry = snap.get(name)
    if not entry:
        return {}
    out = {}
    for s in entry["samples"]:
        sl = s["labels"]
        if sl.get("node") == node and "device" in sl:
            out[sl["device"]] = out.get(sl["device"], 0.0) \
                + s.get("value", 0.0)
    return out


def digest(snap: dict) -> dict:
    """Per-node counter totals + gauges + a timestamp, ready for rate
    computation between two polls."""
    out = {"t": time.time(), "nodes": {}}
    for node in _nodes(snap):
        d = {k: _sum_counter(snap, name, node)
             for k, name in NODE_COUNTERS.items()}
        d["start"] = _gauge(snap, "scanner_tpu_process_start_time_seconds",
                            node)
        d["evalq"] = _gauge(snap, "scanner_tpu_stage_queue_depth", node,
                            stage="evaluate")
        d["saveq"] = _gauge(snap, "scanner_tpu_stage_queue_depth", node,
                            stage="save")
        # per-chip utilization (evaluator affinity): tasks + busy
        # seconds per assigned device — the series the tool predated;
        # without them a wedged chip hides inside the node totals
        d["dev_tasks"] = _per_device(
            snap, "scanner_tpu_device_tasks_total", node)
        d["dev_busy"] = _per_device(
            snap, "scanner_tpu_device_busy_seconds_total", node)
        # per-chip memory (util/memstats.py): backend-reported HBM
        # occupancy/limit plus the allocation ledger's engine-owned
        # live bytes (summed across buffer kinds)
        d["dev_hbm"] = _per_device(
            snap, "scanner_tpu_device_hbm_bytes_in_use", node)
        d["dev_hbm_limit"] = _per_device(
            snap, "scanner_tpu_device_hbm_limit_bytes", node)
        d["dev_ledger"] = _per_device(
            snap, "scanner_tpu_ledger_live_bytes", node)
        # paged frame cache (engine/framecache.py): resident page bytes
        # and hit/miss counters per device — a hot-clip workload should
        # show CACHE MB climbing and CHIT% approaching 100
        d["dev_cache"] = _per_device(
            snap, "scanner_tpu_framecache_live_bytes", node)
        d["dev_cache_hits"] = _per_device(
            snap, "scanner_tpu_framecache_hits_total", node)
        d["dev_cache_misses"] = _per_device(
            snap, "scanner_tpu_framecache_misses_total", node)
        # compute-efficiency plane (util/coststats.py): XLA compiles by
        # persistent-cache outcome, and the per-(op, device) roofline
        # verdict at the steady-state bucket
        d["compile"] = _sum_by_label(
            snap, "scanner_tpu_compile_total", node, "cache")
        d["ops"] = _op_efficiency(snap, node)
        out["nodes"][node] = d
    return out


def _hit_rate(compile_by_cache: dict):
    """Persistent-cache hit rate, or None when no cache is configured
    (every observed compile was `uncached`)."""
    hit = compile_by_cache.get("hit", 0.0)
    miss = compile_by_cache.get("miss", 0.0)
    return hit / (hit + miss) if (hit + miss) else None


def _rate(cur: dict, prev: dict, key: str, now: float) -> float:
    """delta/interval vs the previous poll, or since-start average."""
    if prev is not None:
        dt = max(cur["_dt"], 1e-6)
        return max(cur[key] - prev.get(key, 0.0), 0.0) / dt
    up = max(now - cur["start"], 1e-6) if cur.get("start") else None
    return cur[key] / up if up else 0.0


# -- rendering --------------------------------------------------------------

def render(status: dict, cur: dict, prev: dict, master: str,
           health: dict = None, shards: list = None) -> str:
    now = cur["t"]
    lines = [f"torch-top  master={master}  "
             f"{time.strftime('%H:%M:%S', time.localtime(now))}"]
    if status is None or "tasks_done" not in status:
        lines.append("no active bulk job")
    else:
        fps = status.get("stage_fps") or {}
        eta = status.get("eta_seconds")
        lines.append(
            f"bulk: {status['tasks_done']}/{status['total_tasks']} tasks"
            f"  workers={status.get('num_workers', '?')}"
            f"  load {fps.get('load', 0):.1f} r/s"
            f"  eval {fps.get('evaluate', 0):.1f} r/s"
            f"  save {fps.get('save', 0):.1f} r/s"
            + (f"  ETA {eta:.0f}s" if eta is not None else "")
            + ("  FINISHED" if status.get("finished") else ""))
        per_job = status.get("per_job") or {}
        lagging = [(j, d) for j, d in sorted(per_job.items())
                   if d["tasks_done"] < d["tasks_total"]]
        if len(per_job) > 1:
            shown = lagging[:8]
            lines.append(f"jobs: {len(per_job)} total, "
                         f"{len(per_job) - len(lagging)} complete"
                         + ("; in flight: " + ", ".join(
                             f"#{j} {d['tasks_done']}/{d['tasks_total']}"
                             + (" [blacklisted]" if d.get("blacklisted")
                                else "")
                             for j, d in shown) if shown else ""))
    # per-shard control-plane columns (docs/robustness.md §Sharded
    # control plane): one row per master shard — map epoch divergence,
    # failover replays, stale-map NACKs and RPC coalescing per shard.
    # A dead shard renders UP=NO instead of silently vanishing.
    if shards:
        lines.append("")
        lines.append(f"{'SHARD':>5} {'ADDR':20} {'UP':>3} {'EPOCH':>6} "
                     f"{'FAILOVER':>9} {'STALEMAP':>9} {'COALESCED':>10}")
        for r in shards:
            if r.get("up"):
                lines.append(
                    f"{r['shard']:>5} {str(r.get('addr', '?')):20} "
                    f"{'yes':>3} {r.get('map_epoch', 0):>6.0f} "
                    f"{r.get('failovers', 0):>9.0f} "
                    f"{r.get('stale_map_rejections', 0):>9.0f} "
                    f"{r.get('rpcs_coalesced', 0):>10.0f}")
            else:
                lines.append(
                    f"{r['shard']:>5} {str(r.get('addr', '?')):20} "
                    f"{'NO':>3} {'-':>6} {'-':>9} {'-':>9} {'-':>10}")
    lines.append("")
    hdr = (f"{'NODE':10} {'DECODE f/s':>10} {'EVAL r/s':>9} "
           f"{'H2D MB/s':>9} {'D2H MB/s':>9} {'EVALQ':>6} {'SAVEQ':>6} "
           f"{'RETRY':>6}")
    lines.append(hdr)
    prev_nodes = (prev or {}).get("nodes", {})
    for node, d in sorted(cur["nodes"].items()):
        p = prev_nodes.get(node)
        if p is not None:
            d["_dt"] = cur["t"] - prev["t"]
        lines.append(
            f"{node:10} "
            f"{_rate(d, p, 'decode_f', now):>10.1f} "
            f"{_rate(d, p, 'eval_r', now):>9.1f} "
            f"{_rate(d, p, 'h2d_b', now) / 1e6:>9.2f} "
            f"{_rate(d, p, 'd2h_b', now) / 1e6:>9.2f} "
            f"{d['evalq']:>6.0f} {d['saveq']:>6.0f} "
            f"{d['retries']:>6.0f}")
    # per-chip breakdown (evaluator affinity + memstats): one row per
    # (node, device) that has taken tasks or holds memory — chip
    # imbalance (a device stuck while siblings climb) and HBM skew are
    # invisible in the node totals above
    dev_rows = []
    for node, d in sorted(cur["nodes"].items()):
        tasks_by = d.get("dev_tasks") or {}
        devs = set(tasks_by) | set(d.get("dev_hbm") or {}) \
            | set(d.get("dev_ledger") or {})
        if not devs or (devs == {"default"} and not d.get("dev_hbm")):
            continue
        p = prev_nodes.get(node) or {}
        for dev in sorted(devs):
            tasks = tasks_by.get(dev, 0.0)
            busy = (d.get("dev_busy") or {}).get(dev, 0.0)
            p_busy = (p.get("dev_busy") or {}).get(dev, 0.0)
            if "_dt" in d:
                util = max(busy - p_busy, 0.0) / max(d["_dt"], 1e-6)
            else:
                up = max(now - d["start"], 1e-6) if d.get("start") else None
                util = busy / up if up else 0.0
            hbm = (d.get("dev_hbm") or {}).get(dev, 0.0)
            limit = (d.get("dev_hbm_limit") or {}).get(dev, 0.0)
            ledger = (d.get("dev_ledger") or {}).get(dev, 0.0)
            pct = f"{hbm / limit * 100:>5.1f}%" if limit else "    -"
            cache_mb = (d.get("dev_cache") or {}).get(dev, 0.0) / 1e6
            chits = (d.get("dev_cache_hits") or {}).get(dev, 0.0)
            cmiss = (d.get("dev_cache_misses") or {}).get(dev, 0.0)
            chit = f"{chits / (chits + cmiss) * 100:>5.1f}%" \
                if chits + cmiss else "    -"
            dev_rows.append(
                f"{node:10} {dev:>10} {tasks:>7.0f} {busy:>8.1f} "
                f"{min(util, 1.0) * 100:>6.1f}% {hbm / 1e6:>9.1f} "
                f"{pct:>6} {ledger / 1e6:>9.1f} {cache_mb:>9.1f} "
                f"{chit:>6}")
    if dev_rows:
        lines.append("")
        lines.append(f"{'NODE':10} {'DEVICE':>10} {'TASKS':>7} "
                     f"{'BUSY s':>8} {'UTIL':>7} {'HBM MB':>9} "
                     f"{'HBM%':>6} {'LEDG MB':>9} {'CACHE MB':>9} "
                     f"{'CHIT%':>6}")
        lines.extend(dev_rows)
    # per-op roofline (util/coststats.py): EFF% against the device peak
    # for the binding resource, at the steady-state bucket — a slow op
    # at high EFF% needs more chips, at low EFF% a better kernel.  The
    # XCACHE column is the node's persistent-compile-cache hit rate.
    eff_rows = []
    # fused chain ids ("a+b+c") outgrow the classic 16-char op column:
    # size it to the widest label in this snapshot
    opw = max([16] + [len(op) for _, d in cur["nodes"].items()
                      for (op, _dev) in (d.get("ops") or {})])
    for node, d in sorted(cur["nodes"].items()):
        ops = d.get("ops") or {}
        hr = _hit_rate(d.get("compile") or {})
        hr_s = f"{hr * 100:.0f}%" if hr is not None else "-"
        for (op, dev), o in sorted(ops.items()):
            eff_rows.append(
                f"{node:10} {op:{opw}} {dev:>9} {o['bucket']:>6} "
                f"{o['efficiency'] * 100:>6.1f}% "
                f"{'compute' if o['compute_bound'] else 'memory':>8} "
                f"{o['flops_per_s'] / 1e9:>9.2f} "
                f"{o['bytes_per_s'] / 1e9:>8.3f} {hr_s:>6}")
    if eff_rows:
        lines.append("")
        lines.append(f"{'NODE':10} {'OP':{opw}} {'DEVICE':>9} "
                     f"{'BUCKET':>6} "
                     f"{'EFF%':>7} {'BOUND':>8} {'GFLOP/s':>9} "
                     f"{'GB/s':>8} {'XCACHE':>6}")
        lines.extend(eff_rows)
    # GANG SKEW (docs/observability.md §Cross-host time): per-gang
    # straggler attribution from the master's barrier-arrival fold —
    # which host made each gang slow, by how much, and whether the
    # step was barrier-bound (a late arrival) or collective-bound
    skew = ((status or {}).get("stragglers") or {}).get("gangs") or []
    if skew:
        lines.append("")
        lines.append(f"GANG SKEW{'':5} {'GANG':>5} {'EPOCH':>5} "
                     f"{'SKEW ms':>8} {'SLOWEST':>10} {'LAG ms':>7} "
                     f"{'BOUND':>10}")
        for g in skew[:8]:
            lines.append(
                f"{'':14} {str(g.get('gang')):>5} "
                f"{str(g.get('epoch')):>5} "
                f"{g.get('skew_s', 0) * 1e3:>8.1f} "
                f"{str(g.get('slowest')):>10} "
                f"{g.get('lag_s', 0) * 1e3:>7.1f} "
                f"{str(g.get('bound')):>10}")
    # cluster health (GetHealth): the judgment layer — which rules fire
    # where, so "is it healthy" doesn't require reading the counters
    if health:
        firing = health.get("firing") or []
        if firing:
            lines.append("")
            lines.append(f"ALERTS ({health.get('status', '?')})")
            for f in firing[:10]:
                lbl = ",".join(
                    f"{k}={v}" for k, v in
                    sorted((f.get("labels") or {}).items()))
                since = f.get("since")
                age = f"{max(now - since, 0):.0f}s" if since else "-"
                lines.append(
                    f"  {str(f.get('node', '-')):10} "
                    f"{f.get('rule', '?'):24} "
                    f"{f.get('severity', '?'):8} {lbl:24} {age:>6}")
            if len(firing) > 10:
                lines.append(f"  ... and {len(firing) - 10} more")
        elif health.get("status") == "ok":
            lines.append("")
            lines.append("health: ok (0 alerts firing)")
    return "\n".join(lines)


def json_doc(status: dict, cur: dict, master: str,
             health: dict = None, shards: list = None) -> dict:
    """The --json document: everything --once renders, machine-readable
    (scripts used to scrape the human table).  Per-node counter totals
    since process start plus the per-device utilization/memory maps."""
    nodes = {}
    for node, d in sorted(cur["nodes"].items()):
        nodes[node] = {
            "decoded_frames": d["decode_f"],
            "eval_rows": d["eval_r"],
            "h2d_bytes": d["h2d_b"],
            "d2h_bytes": d["d2h_b"],
            "retries": d["retries"],
            "eval_queue": d["evalq"],
            "save_queue": d["saveq"],
            "process_start_time": d.get("start"),
            "devices": {
                dev: {
                    "tasks": (d.get("dev_tasks") or {}).get(dev, 0.0),
                    "busy_seconds":
                        (d.get("dev_busy") or {}).get(dev, 0.0),
                    "hbm_bytes_in_use":
                        (d.get("dev_hbm") or {}).get(dev, 0.0),
                    "hbm_limit_bytes":
                        (d.get("dev_hbm_limit") or {}).get(dev, 0.0),
                    "ledger_live_bytes":
                        (d.get("dev_ledger") or {}).get(dev, 0.0),
                    "framecache_live_bytes":
                        (d.get("dev_cache") or {}).get(dev, 0.0),
                    "framecache_hits":
                        (d.get("dev_cache_hits") or {}).get(dev, 0.0),
                    "framecache_misses":
                        (d.get("dev_cache_misses") or {}).get(dev, 0.0),
                }
                for dev in sorted(set(d.get("dev_tasks") or {})
                                  | set(d.get("dev_hbm") or {})
                                  | set(d.get("dev_ledger") or {})
                                  | set(d.get("dev_cache") or {}))
            },
            # compute-efficiency plane: compile counts by cache outcome
            # (+ derived hit rate) and the per-op roofline rows the
            # human table renders
            "compile": dict(d.get("compile") or {},
                            hit_rate=_hit_rate(d.get("compile") or {})),
            "ops": {
                f"{op}@{dev}": o
                for (op, dev), o in sorted((d.get("ops") or {}).items())
            },
        }
    return {"time": cur["t"], "master": master, "status": status,
            "health": health, "nodes": nodes,
            # sharded control plane: one entry per master shard with
            # map epoch / failover / stale-map / coalescing columns
            # (None for a single-master cluster)
            "shards": shards,
            # per-gang straggler attribution (also inside
            # status.stragglers.gangs; surfaced top-level so scripts
            # need not know the straggler summary's shape)
            "gang_skew": ((status or {}).get("stragglers") or {})
            .get("gangs") or []}


# -- main -------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="live per-job/per-worker telemetry for a cluster of "
                    "the PyTorch/CUDA port (top-style)")
    ap.add_argument("--master", default="localhost:5000",
                    help="master address host:port (default %(default)s)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="poll period seconds (default %(default)s)")
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (for scripts)")
    ap.add_argument("--json", action="store_true",
                    help="print one machine-readable JSON snapshot and "
                         "exit (mirrors --once; no table scraping)")
    args = ap.parse_args(argv)

    from scanner_tpu_torch.engine.rpc import RpcClient
    from scanner_tpu_torch.engine.service import MASTER_SERVICE

    client = RpcClient(args.master, MASTER_SERVICE, timeout=10.0)
    # sharded control plane: resolve the versioned shard map from the
    # dialed master (any shard serves it) and dial every shard — the
    # poll loop then fans in instead of assuming one master
    shard_addrs = _resolve_shards(client)
    shard_clients = {}
    if shard_addrs:
        for sid, addr in sorted(shard_addrs.items()):
            shard_clients[sid] = client if addr == client.address \
                else RpcClient(addr, MASTER_SERVICE, timeout=10.0)
    prev = None
    try:
        while True:
            shard_rows = None
            if shard_clients:
                snap, status, health, shard_rows = \
                    _poll_sharded(shard_clients)
                if snap is None:
                    print(f"torch-top: no shard of {args.master} "
                          f"reachable", file=sys.stderr)
                    return 2
            else:
                reply = client.try_call("GetMetrics", retries=1)
                if reply is None:
                    print(f"torch-top: master {args.master} "
                          f"unreachable", file=sys.stderr)
                    return 2
                snap = reply["snapshot"]
                status = client.try_call("GetJobStatus", bulk_id=None,
                                         retries=1)
                # cluster-wide health roll-up + firing alerts
                # (GetHealth); best-effort like the status poll
                health = client.try_call("GetHealth", retries=0)
            if status is not None and "error" in status \
                    and "tasks_done" not in status:
                status = None
            cur = digest(snap)
            if args.json:
                import json as _json
                print(_json.dumps(json_doc(status, cur, args.master,
                                           health, shard_rows)))
                return 0
            frame = render(status, cur, prev, args.master, health,
                           shard_rows)
            if args.once:
                print(frame)
                return 0
            # clear screen + home, like top
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            prev = cur
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        for c in shard_clients.values():
            if c is not client:
                c.close()
        client.close()


if __name__ == "__main__":
    sys.exit(main())
