"""torch-trace: dump and analyze a port bulk's merged cross-host trace.

The counterpart of tools/scanner_trace.py for a cluster of the PyTorch/
CUDA port (scanner_tpu_torch/util/tracing.py): pulls the port master's
assembled span tree of a bulk (GetTrace RPC — every worker's
task/stage/op spans plus the master's scheduling spans, one trace_id per
job) and either writes a Perfetto/Chrome JSON, prints straggler
analytics, or audits chain completeness.  Flags, exit codes and --json
documents are scanner_trace's.

    python tools/torch_trace.py --master localhost:5000 -o bulk.json
    python tools/torch_trace.py --master localhost:5000 --bulk 3 --top 10
    python tools/torch_trace.py --master localhost:5000 --verify

Exit codes: 0 ok, 1 incomplete chains (--verify), 2 master unreachable /
no such bulk.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _fmt_stragglers(trace_id: str, s: dict) -> str:
    lines = [f"trace {trace_id}: {s.get('spans', 0)} spans"
             + (f" ({s['spans_dropped']} dropped)"
                if s.get("spans_dropped") else "")]
    per = s.get("per_stage") or {}
    if per:
        lines.append(f"{'STAGE':>20} {'COUNT':>7} {'TOTAL s':>9} "
                     f"{'MEAN s':>8} {'MAX s':>8}")
        for name, st in per.items():
            lines.append(f"{name:>20} {st['count']:>7} "
                         f"{st['total_s']:>9.3f} {st['mean_s']:>8.4f} "
                         f"{st['max_s']:>8.4f}")
    slow = s.get("slowest_tasks") or []
    if slow:
        lines.append("")
        lines.append(f"{'SLOWEST':>8} {'JOB':>4} {'TASK':>5} "
                     f"{'SECONDS':>8} {'NODE':>9}  SPAN")
        for i, t in enumerate(slow):
            lines.append(f"{'#%d' % (i + 1):>8} {str(t['job']):>4} "
                         f"{str(t['task']):>5} {t['seconds']:>8.3f} "
                         f"{str(t['node']):>9}  {t['span_id']}")
    gangs = s.get("gangs") or []
    if gangs:
        lines.append("")
        lines.append(f"{'GANG':>5} {'EPOCH':>5} {'SKEW ms':>8} "
                     f"{'SLOWEST':>10} {'LAG ms':>7} {'BOUND':>10}")
        for g in gangs:
            lines.append(
                f"{str(g.get('gang')):>5} {str(g.get('epoch')):>5} "
                f"{g.get('skew_s', 0) * 1e3:>8.1f} "
                f"{str(g.get('slowest')):>10} "
                f"{g.get('lag_s', 0) * 1e3:>7.1f} "
                f"{str(g.get('bound')):>10}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="dump/analyze a bulk's merged cross-host trace "
                    "(spans assembled by the master from every node)")
    ap.add_argument("--master", default="localhost:5000",
                    help="master address host:port (default %(default)s)")
    ap.add_argument("--bulk", type=int, default=None,
                    help="bulk id (default: the active/most recent bulk)")
    ap.add_argument("-o", "--out", default=None,
                    help="write the merged Perfetto/Chrome JSON here")
    ap.add_argument("--top", type=int, default=10,
                    help="straggler rows to print (default %(default)s)")
    ap.add_argument("--verify", action="store_true",
                    help="audit chain completeness: every task span must "
                         "chain unbroken to the root with stage + op "
                         "children (exit 1 on breaks)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output (straggler summary / "
                         "verify report)")
    ap.add_argument("--raw-clocks", action="store_true",
                    help="keep each host's uncorrected timestamps "
                         "instead of rebasing remote spans onto master "
                         "time via the per-node clock offsets")
    args = ap.parse_args(argv)

    from scanner_tpu_torch.engine.rpc import RpcClient
    from scanner_tpu_torch.engine.service import MASTER_SERVICE
    from scanner_tpu_torch.util import tracing

    client = RpcClient(args.master, MASTER_SERVICE, timeout=30.0)
    try:
        reply = client.try_call("GetTrace", bulk_id=args.bulk,
                                raw_clocks=args.raw_clocks, retries=1)
    finally:
        client.close()
    if reply is None:
        print(f"torch-trace: master {args.master} unreachable",
              file=sys.stderr)
        return 2
    if "spans" not in reply:
        print(f"torch-trace: {reply.get('error', 'no trace')}",
              file=sys.stderr)
        return 2
    spans = reply["spans"]
    if args.out:
        tracing.write_chrome_trace(spans, args.out)
        clocks = "raw clocks" if args.raw_clocks else (
            "clock-rebased" if reply.get("clock_rebased")
            else "no clock correction")
        print(f"torch-trace: wrote {len(spans)} spans to {args.out} "
              f"({clocks})", file=sys.stderr)
    if args.verify:
        report = tracing.verify_chain(spans)
        if args.json:
            print(json.dumps(report, indent=1))
        else:
            print(f"tasks={report['tasks']} "
                  f"trace_ids={len(report['trace_ids'])} "
                  f"complete={report['complete']}")
            for b in report["broken"][:20]:
                print(f"  BROKEN: {b}")
        return 0 if report["complete"] else 1
    if not args.out or args.json:
        # recompute from the full dump (same shape the master maintains
        # incrementally) so --top honors the requested N
        summary = tracing.straggler_summary(spans, top_n=args.top)
        summary["spans"] = len(spans)
        summary["spans_dropped"] = reply.get("spans_dropped", 0)
        if args.json:
            print(json.dumps(summary, indent=1))
        else:
            print(_fmt_stragglers(reply.get("trace_id", "?"), summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
