"""torch-cost: compute-efficiency report for a port cluster.

The counterpart of tools/scanner_cost.py for a cluster of the PyTorch/
CUDA port (scanner_tpu_torch/util/coststats.py): dials the port
master's GetCompileLedger RPC and renders, per node,

  * the roofline table — achieved FLOP/s / bytes/s, the
    compute-vs-memory-bound verdict and EFF% per (op, device, bucket),
    the device being a card's torch label (`cuda:0`);
  * the compile ledger — the PORT's: what the first call of an (op,
    bucket, signature) paid to build and bind a kernel library
    (`kinds` "library": an nvcc build, `cache` "hit" when it was
    already built) or to capture a fused chain's CUDA graph (`kinds`
    "graph", engine/evaluate.py `FusedKernelInstance._capture` through
    `coststats.note_compile(..., "graph")`).  Not XLA executables: the
    port compiles none, so EXEC B and FLOPS read 0 / `-`.

    python tools/torch_cost.py --master localhost:5000
    python tools/torch_cost.py --master localhost:5000 --ledger 20
    python tools/torch_cost.py --master localhost:5000 --json
    python tools/torch_cost.py --detail BENCH_DETAIL.json   # offline

Flags, exit codes and the --json document are scanner_cost's.  Exit
codes: 0 ok, 2 master unreachable / detail file unreadable.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _fmt_rate(v: float) -> str:
    for unit, div in (("T", 1e12), ("G", 1e9), ("M", 1e6), ("K", 1e3)):
        if v >= div:
            return f"{v / div:.2f}{unit}"
    return f"{v:.0f}"


def render_ops(node: str, ops) -> list:
    lines = []
    if not ops:
        return lines
    # fused chain ids ("Resize+Blur+Histogram") exceed the classic
    # 16-char op column: widen to the longest label on screen
    w = max(16, max(len(o["op"]) for o in ops))
    lines.append(f"{'OP':{w}} {'DEVICE':>9} {'BUCKET':>6} {'CALLS':>6} "
                 f"{'EFF%':>7} {'BOUND':>8} {'FLOP/s':>9} {'B/s':>9} "
                 f"{'SRC':>8}")
    for o in ops:
        lines.append(
            f"{o['op']:{w}} {o['device']:>9} {o['bucket']:>6} "
            f"{o['calls']:>6} {o['efficiency'] * 100:>6.1f}% "
            f"{o['bound']:>8} {_fmt_rate(o['flops_per_s']):>9} "
            f"{_fmt_rate(o['bytes_per_s']):>9} "
            f"{o.get('cost_source', '?'):>8}")
    return lines


def render_ledger(entries, n: int) -> list:
    lines = []
    if not entries:
        return lines
    shown = entries[-n:]
    w = max(16, max(len(e["op"]) for e in shown))
    lines.append(f"{'OP':{w}} {'DEVICE':>9} {'BUCKET':>6} {'CACHE':>8} "
                 f"{'SECONDS':>8} {'EXEC B':>9} {'FLOPS':>9} {'TASK':>8}")
    for e in shown:
        lines.append(
            f"{e['op']:{w}} {e['device']:>9} {e['bucket']:>6} "
            f"{e['cache']:>8} {e['compile_s']:>8.4f} "
            f"{e.get('exec_bytes') or 0:>9} "
            f"{_fmt_rate(e['flops']) if e.get('flops') else '-':>9} "
            f"{str(e.get('task') or '-'):>8}")
    return lines


def render(nodes: dict, ledger_n: int) -> str:
    lines = []
    for node in sorted(nodes):
        rep = nodes[node] or {}
        summ = rep.get("summary") or {}
        hr = summ.get("cache_hit_rate")
        lines.append(
            f"== {node}: {summ.get('compiles', 0)} compiles in "
            f"{summ.get('compile_seconds', 0.0)}s "
            f"({summ.get('entries', 0)} ledger entries"
            + (f", {summ.get('entries_seen', 0)} seen" if
               summ.get("entries_seen", 0) != summ.get("entries", 0)
               else "")
            + "), cache hit rate "
            + (f"{hr:.0%}" if hr is not None else "n/a (no cache)"))
        ops = render_ops(node, rep.get("op_efficiency") or [])
        if ops:
            lines.append("")
            lines.extend(ops)
        led = render_ledger(rep.get("ledger") or [], ledger_n)
        if led:
            lines.append("")
            lines.extend(led)
        lines.append("")
    return "\n".join(lines).rstrip() or "no efficiency data recorded"


def detail_nodes(path: str):
    """Offline mode: reshape a BENCH_DETAIL.json op_efficiency digest
    into the per-node report shape the renderer expects."""
    with open(path) as f:
        detail = json.load(f)
    for d in detail if isinstance(detail, list) else []:
        if isinstance(d, dict) and d.get("config") == "op_efficiency":
            return {"bench": {"summary": d.get("compile") or {},
                              "op_efficiency": d.get("ops") or [],
                              "ledger": []}}
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="per-op roofline efficiency + compile ledger (kernel "
                    "builds and CUDA-graph captures) for a port cluster")
    ap.add_argument("--master", default=None,
                    help="master address host:port")
    ap.add_argument("--detail", default=None,
                    help="offline: read a BENCH_DETAIL.json "
                         "op_efficiency digest instead of a cluster")
    ap.add_argument("--ledger", type=int, default=10,
                    help="newest compile-ledger entries to show per "
                         "node (default %(default)s)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    if args.detail:
        try:
            nodes = detail_nodes(args.detail)
        except (OSError, ValueError) as e:
            print(f"torch-cost: cannot read {args.detail}: {e}",
                  file=sys.stderr)
            return 2
        if nodes is None:
            print(f"torch-cost: no op_efficiency digest in "
                  f"{args.detail}", file=sys.stderr)
            return 2
    else:
        from scanner_tpu_torch.engine.rpc import RpcClient
        from scanner_tpu_torch.engine.service import MASTER_SERVICE

        master = args.master or "localhost:5000"
        client = RpcClient(master, MASTER_SERVICE, timeout=10.0)
        try:
            reply = client.try_call("GetCompileLedger", retries=1)
        finally:
            client.close()
        if reply is None or "nodes" not in reply:
            print(f"torch-cost: master {master} unreachable",
                  file=sys.stderr)
            return 2
        nodes = reply["nodes"]

    if args.json:
        print(json.dumps({"nodes": nodes}, indent=1, default=str))
    else:
        print(render(nodes, args.ledger))
    return 0


if __name__ == "__main__":
    sys.exit(main())
