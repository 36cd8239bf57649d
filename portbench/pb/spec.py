"""Finds what BENCHMARK.json names, by name: a cell's entry and its own file
(portbench/cells/<cell>.json), its configuration's file, the module of the
configuration's family (portbench/families/<family>.py: its reference and
compared numbers), its traffic mix (portbench/traffic/<traffic>.json) and
the readers of its metrics (portbench/metrics/<metric>.py). A later cell,
configuration, family, traffic mix or metric is a new file and a new
entry; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]  # portbench/
REPO_DIR = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of BENCHMARK.json with everything it names."""
    name: str
    entry: dict  # the workloads entry
    limits: dict  # portbench/cells/<name>.json "limits": of `correct`
    config_name: str
    config: dict  # the configuration file's content
    traffic_name: str  # the mix whose recordings the cell sends
    traffic: dict  # its parameters, with "entry" and "clients"
    end_to_end: list  # metric entries this cell reports with --trace 0
    per_layer: list  # metric entries this cell reports with --trace 1
    bench_dir: Path = BENCH_DIR  # where its files and metric readers are


def _reports(metric: dict, cell: str, bench: dict) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    if metric in bench.get("end_to_end", []):
        return True
    # a per-layer metric without a list: every cell that reports its
    # end-to-end metric
    moved = next(m for m in bench["end_to_end"] if m["name"] == metric["moves"])
    return _reports(moved, cell, bench)


def load_traffic(name: str, bench_dir: Path = BENCH_DIR) -> tuple:
    """(name of the mix that lays the recordings out, its parameters with
    the arrivals: "entry" ("cli": cli.main one recording after another;
    "server": EncodeServer) and "clients" (recordings in flight)). A mix
    may take its recordings from another ("recordings": name) and set only
    the arrivals."""
    mix = load_json(bench_dir / "traffic" / f"{name}.json")
    base = name
    if "recordings" in mix:
        base = mix["recordings"]
        mix = dict(load_json(bench_dir / "traffic" / f"{base}.json"),
                   **{k: v for k, v in mix.items() if k != "recordings"})
    mix.setdefault("entry", "cli")
    mix.setdefault("clients", 1)
    return base, mix


def load_cell(name: str, bench: dict | None = None,
              repo: Path = REPO_DIR, bench_dir: Path = BENCH_DIR) -> Cell:
    bench = bench if bench is not None else load_json(repo / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == entry["config"])
    traffic_name, traffic = load_traffic(entry["traffic"], bench_dir)
    config = load_json(repo / conf_entry["file"])
    family = family_path(config.get("family"), bench_dir)
    if not family.is_file():
        raise FileNotFoundError(
            f"no module for the family {config.get('family')!r} of the "
            f"configuration {conf_entry['name']!r}: looked for {family}")
    return Cell(
        name=name, entry=entry,
        limits=load_json(bench_dir / "cells" / f"{name}.json")["limits"],
        config_name=entry["config"],
        config=config,
        traffic_name=traffic_name, traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"]
                    if _reports(m, name, bench)],
        per_layer=[m for m in bench["per_layer"]
                   if _reports(m, name, bench)], bench_dir=bench_dir)


def _load_module(prefix: str, path: Path):
    spec = importlib.util.spec_from_file_location(
        prefix + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The module portbench/metrics/<name>.py; its read(run) returns the
    metric's value, or None where the run holds nothing to read."""
    return _load_module("portbench_metric_",
                        bench_dir / "metrics" / f"{name}.py")


def family_path(name, bench_dir: Path = BENCH_DIR) -> Path:
    return bench_dir / "families" / f"{name}.py"


def load_family(cell: Cell):
    """The module of the cell's configuration's family, which gives
    `reference(config, rec, truth, geometry, logo_planes, dtype, device)`
    (an object with `num_out`, `seams()`, `frames(indices)` and
    `filter_result()`), `numbers(ref, expected, served, cm_results,
    filter_results)` (the compared numbers, keyed as the cell's limits) and
    `guarantee_control(ref, keep)` (the frames, output count and filter
    results of a program that breaks the configuration's guarantee)."""
    return _load_module("portbench_family_",
                        family_path(cell.config["family"], cell.bench_dir))
