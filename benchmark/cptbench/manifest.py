"""The manifest (``BENCHMARK.json``) and the files it names, found by name.

A cell names a configuration and a traffic mix; each is a file of its own:
``configs/<config>.json`` (the deployment's sizes and its scene arrays),
``traffic/<traffic>.json`` (the job's parameters, read by the general job
driver ``jobs/<job>.py`` that the mix names), ``checks/<cell>.json`` (the
limit of every number that decides ``correct``) and, for every metric,
``metrics/<metric>.py`` (its reader). Nothing here lists cells,
configurations, mixes or metrics: adding one is adding files and entries.
"""
from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(bench_dir: str, kind: str, name: str) -> dict:
    path = os.path.join(bench_dir, kind, name + ".json")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} file {path}")
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, workload: str, bench_dir: str = BENCH_DIR) -> dict:
    """Everything one cell needs: its manifest entry, its configuration,
    its traffic mix, its limits and its metrics (end-to-end first), each
    metric with its reader."""
    entry = next((w for w in manifest["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = _json(bench_dir, "configs", entry["config"])
    traffic = _json(bench_dir, "traffic", entry["traffic"])
    limits = _json(bench_dir, "checks", workload)
    return dict(entry=entry, config=config, traffic=traffic, limits=limits,
                end_to_end=metrics_of(manifest, "end_to_end", workload),
                per_layer=metrics_of(manifest, "per_layer", workload),
                job=job_module(traffic["job"], bench_dir))


def metrics_of(manifest: dict, kind: str, workload: str) -> List[dict]:
    """The metrics of ``kind`` this cell reports: those that list it, and
    those without a ``workloads`` key (for a per-layer metric: where the
    cell reports the end-to-end metric it moves)."""
    e2e = {m["name"] for m in metrics_of(manifest, "end_to_end", workload)} \
        if kind == "per_layer" else None
    out = []
    for m in manifest[kind]:
        if "workloads" in m:
            if workload in m["workloads"]:
                out.append(m)
        elif kind == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


def _load_file(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or not os.path.isfile(path):
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``read(run)`` of ``metrics/<metric>.py``: the metric's value, or None
    where the run holds nothing to read it from."""
    mod = _load_file(os.path.join(bench_dir, "metrics", metric + ".py"),
                     "cptbench_metric_" + re.sub(r"\W", "_", metric))
    return mod.read


def job_module(job: str, bench_dir: str = BENCH_DIR):
    """The job driver ``jobs/<job>.py``: its ``Job`` class runs a traffic
    mix of that kind."""
    return _load_file(os.path.join(bench_dir, "jobs", job + ".py"),
                      "cptbench_job_" + re.sub(r"\W", "_", job))


def problems(manifest: dict, bench_dir: str = BENCH_DIR) -> List[str]:
    """What in the manifest breaks the benchmark's contract or names a file
    that is missing; empty when sound."""
    bad = []
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in manifest.get(kind, []):
            names.append((kind, e.get("name", "")))
            if not NAME.match(e.get("name", "")):
                bad.append(f"{kind}: bad name {e.get('name')!r}")
            if kind in ("end_to_end", "per_layer"):
                if not UNIT.match(e.get("unit", "")):
                    bad.append(f"{e['name']}: bad unit {e.get('unit')!r}")
                if e.get("better") not in ("lower", "higher"):
                    bad.append(f"{e['name']}: better must be lower or higher")
                if e.get("source") not in SOURCES:
                    bad.append(f"{e['name']}: bad source {e.get('source')!r}")
                if not os.path.isfile(os.path.join(bench_dir, "metrics",
                                                   e["name"] + ".py")):
                    bad.append(f"{e['name']}: no reader metrics/{e['name']}.py")
    for kind in ("configs", "workloads"):
        seen = [n for k, n in names if k == kind]
        if len(seen) != len(set(seen)):
            bad.append(f"{kind}: duplicate names")
    metric_names = [n for k, n in names if k in ("end_to_end", "per_layer")]
    if len(metric_names) != len(set(metric_names)):
        bad.append("metrics: duplicate names")
    configs = {c["name"] for c in manifest.get("configs", [])}
    for c in manifest.get("configs", []):
        for k in c.get("reduced", []):
            if not NAME.match(k):
                bad.append(f"{c['name']}: bad reduced key {k!r}")
        if not os.path.isfile(os.path.join(os.path.dirname(bench_dir),
                                           c["file"])):
            bad.append(f"{c['name']}: no file {c['file']}")
    pairs = set()
    for w in manifest.get("workloads", []):
        for key in ("config", "traffic"):
            if not NAME.match(w.get(key, "")):
                bad.append(f"{w['name']}: bad {key} {w.get(key)!r}")
        if w.get("config") not in configs:
            bad.append(f"{w['name']}: unknown config {w.get('config')!r}")
        if (w.get("config"), w.get("traffic")) in pairs:
            bad.append(f"{w['name']}: config and traffic pair repeated")
        pairs.add((w.get("config"), w.get("traffic")))
        if w.get("chips") not in (1, 4):
            bad.append(f"{w['name']}: chips must be 1 or 4")
        for kind, name in (("configs", w.get("config")),
                           ("traffic", w.get("traffic")),
                           ("checks", w["name"])):
            if not os.path.isfile(os.path.join(bench_dir, kind, f"{name}.json")):
                bad.append(f"{w['name']}: no {kind}/{name}.json")
        try:
            e2e = metrics_of(manifest, "end_to_end", w["name"])
            layer = metrics_of(manifest, "per_layer", w["name"])
        except KeyError as err:
            bad.append(f"{w['name']}: {err}")
            continue
        if "setup_s" not in {m["name"] for m in e2e} or len(e2e) < 2:
            bad.append(f"{w['name']}: needs setup_s and another end-to-end metric")
        if not layer:
            bad.append(f"{w['name']}: no per-layer metric")
        for m in layer:
            if m["moves"] not in {x["name"] for x in e2e}:
                bad.append(f"{m['name']}: {w['name']} does not report "
                           f"{m['moves']}")
    return bad
