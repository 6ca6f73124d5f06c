"""BENCHMARK.json and the files each cell names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix.
The configuration's `file` holds its sizes and names its plain
reference (`reference/<name>.py`), and may name a deployment
(`deployments/<name>.py`) that starts the program in place of one local
`Client`; the traffic mix is the data file `traffic/<name>.json`, read
by the general generator (`harness/traffic.py`) or by the generator
`traffic/<name>.py` that its `generator` key names; each per-layer
metric is the reader `metrics/<name>.py`.  Adding a cell adds entries
and files; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _one_line(s: Any) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 \
        and "\n" not in s and "\t" not in s


def contract_errors(doc: Dict[str, Any]) -> List[str]:
    """What in a BENCHMARK.json breaks the benchmark contract's limits on
    keys, names, units and one-line texts; [] when nothing does."""
    errs = []
    top = ("command", "paths", "run_seconds", "configs", "workloads",
           "end_to_end", "per_layer")
    if sorted(doc) != sorted(top):
        errs.append(f"top-level keys {sorted(doc)} != {sorted(top)}")
    for w in doc.get("command", []):
        if not _one_line(w) or w.startswith("/") or ".." in w.split("/"):
            errs.append(f"command word {w!r}")
    for p in doc.get("paths", []):
        if not PATH_RE.match(p) or p.startswith("/") or ".." in p.split("/"):
            errs.append(f"path {p!r}")
    rs = doc.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        errs.append(f"run_seconds {rs!r}")
    keysets = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
    }
    for sec, keys in keysets.items():
        allowed = keys | ({"workloads"} if sec in ("end_to_end", "per_layer")
                          else set())
        names = [e.get("name") for e in doc.get(sec, [])]
        if len(set(names)) != len(names):
            errs.append(f"{sec}: names repeat")
        for e in doc.get(sec, []):
            name = e.get("name")
            if keys - set(e) or set(e) - allowed:
                errs.append(f"{sec} {name}: lacks {keys - set(e)}, "
                            f"extra {set(e) - allowed}")
                continue
            if not NAME_RE.match(str(name)):
                errs.append(f"{sec}: name {name!r}")
            for k in ("why", "layer"):
                if k in e and not _one_line(e[k]):
                    errs.append(f"{sec} {name}: {k} {e[k]!r}")
            if sec == "configs" and not _one_line(e["source"]):
                errs.append(f"{name}: source {e['source']!r}")
            if sec in ("end_to_end", "per_layer"):
                if not UNIT_RE.match(str(e["unit"])):
                    errs.append(f"{name}: unit {e['unit']!r}")
                if e["better"] not in ("lower", "higher"):
                    errs.append(f"{name}: better {e['better']!r}")
                if e["source"] not in SOURCES:
                    errs.append(f"{name}: source {e['source']!r}")
            if sec == "end_to_end":
                b = e["bound"]
                if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
                    errs.append(f"{name}: bound {b!r}")
                if e["source"] not in ("host_clock", "device_trace"):
                    errs.append(f"{name}: source {e['source']!r}")
            if sec == "workloads":
                for k in ("config", "traffic"):
                    if not NAME_RE.match(str(e[k])):
                        errs.append(f"{name}: {k} {e[k]!r}")
                if e["chips"] not in (1, 4):
                    errs.append(f"{name}: chips {e['chips']!r}")
            if sec == "configs":
                if len(e["reduced"]) > 16 or not all(
                        NAME_RE.match(k) for k in e["reduced"]):
                    errs.append(f"{name}: reduced {e['reduced']}")
                if not PATH_RE.match(str(e["file"])):
                    errs.append(f"{name}: file {e['file']!r}")
    if not any(e.get("name") == "setup_s" for e in doc.get("end_to_end", [])):
        errs.append("no setup_s among end_to_end")
    return errs


def load_doc(root: str) -> Dict[str, Any]:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A module from a file by its path (names may carry dots)."""
    name = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """One `workloads` entry with everything it names, resolved."""
    name: str
    chips: int
    config: Dict[str, Any]          # the configuration's file, parsed
    traffic: Dict[str, Any]         # the traffic mix's file, parsed
    reference: Any                  # reference/<config's reference>.py
    generator: Any                  # harness/traffic.py or traffic/<gen>.py
    deployment: Any                 # deployments/<name>.py, None: local
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)
    readers: Dict[str, Any] = field(default_factory=dict)
    run_seconds: int = 10


def _reports(metric: Dict[str, Any], cell: str) -> bool:
    """Whether `cell` reports `metric`: every cell, or those its
    `workloads` list names."""
    return cell in metric.get("workloads", [cell])


def resolve(root: str, workload: str) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json, its files loaded;
    raises KeyError for an unknown cell, FileNotFoundError for a file a
    name points at that is not there."""
    doc = load_doc(root)
    bench = os.path.join(root, doc["paths"][0])
    cells = {w["name"]: w for w in doc["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in doc["configs"]}[w["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench, "traffic", w["traffic"] + ".json")) as f:
        traffic = json.load(f)
    ref_name = config["reference"]
    reference = load_module(os.path.join(bench, "reference",
                                         ref_name + ".py"),
                            f"bench_reference_{ref_name}")
    if "generator" in traffic:
        generator = load_module(os.path.join(
            bench, "traffic", traffic["generator"] + ".py"),
            "bench_traffic_" + traffic["generator"])
    else:
        from benchmark.harness import traffic as generator
    deployment = None
    if "deployment" in config:
        deployment = load_module(os.path.join(
            bench, "deployments", config["deployment"] + ".py"),
            "bench_deployment_" + config["deployment"])
    e2e = [m for m in doc["end_to_end"] if _reports(m, workload)]
    layer = [m for m in doc["per_layer"] if _reports(m, workload)]
    readers = {m["name"]: load_module(
        os.path.join(bench, "metrics", m["name"] + ".py"),
        "bench_metric_" + m["name"])
        for m in layer}
    return Cell(workload, int(w["chips"]), config, traffic, reference,
                generator, deployment, e2e, layer, readers,
                int(doc["run_seconds"]))
