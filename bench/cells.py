"""Cells of the benchmark, found by name.

``BENCHMARK.json`` at the checkout's root lists configurations, cells
(``workloads``) and metrics.  Everything that belongs to one of them is a
file of its own, found by name; there is no registry to edit:

    bench/configs/<config>.json     a configuration (sizes, program options)
    bench/traffic/<cell>.json       a cell's traffic mix; names its driver
    bench/drivers/<driver>.py       a loop (closed-loop transforms, ...)
    bench/metrics/<metric>.py       a per-layer metric's reader, read(view)
    bench/kernels/<family>.json     kernel-name patterns of one family

:func:`validate` holds a manifest to the contract's rules of form.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


@dataclasses.dataclass
class Cell:
    """One workload of the manifest with everything it names loaded."""

    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    end_to_end: list[dict]
    per_layer: list[dict]
    root: pathlib.Path

    @property
    def driver(self):
        return load_module(self.root / "bench" / "drivers"
                           / f"{self.traffic['driver']}.py")


def manifest(root=ROOT) -> dict:
    return json.loads((pathlib.Path(root) / "BENCHMARK.json").read_text())


def load_module(path: pathlib.Path):
    """Import one file of the benchmark by its path (names may hold
    dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    name = "bench_file_" + re.sub(r"\W", "_", path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reports(metric: dict, cell: str) -> bool:
    """A metric without ``workloads`` is reported by every cell."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root=ROOT) -> Cell:
    root = pathlib.Path(root)
    man = manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r}; the manifest has "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((root / "bench" / "traffic"
                          / f"{name}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic=traffic,
                end_to_end=[m for m in man["end_to_end"] if reports(m, name)],
                per_layer=[m for m in man["per_layer"] if reports(m, name)],
                root=root)


def metric_reader(name: str, root=ROOT):
    """The ``read(view)`` function of bench/metrics/<name>.py."""
    return load_module(pathlib.Path(root) / "bench" / "metrics"
                       / f"{name}.py").read


def kernel_family(name: str, root=ROOT) -> list[re.Pattern]:
    doc = json.loads((pathlib.Path(root) / "bench" / "kernels"
                      / f"{name}.json").read_text())
    return [re.compile(p) for p in doc["patterns"]]


def _line(text, what, errs):
    if not isinstance(text, str) or not 1 <= len(text) <= 200 \
            or "\n" in text or "\t" in text:
        errs.append(f"{what}: 1 to 200 characters on one line, no tab")


def validate(man: dict, root=ROOT) -> list[str]:
    """Problems with the manifest's form (empty: none found)."""
    root = pathlib.Path(root)
    errs: list[str] = []
    if set(man) != TOP_KEYS:
        errs.append(f"top-level keys {sorted(man)} != {sorted(TOP_KEYS)}")
        return errs
    paths = man["paths"]
    if not 1 <= len(paths) <= 16 or not all(
            isinstance(p, str) and PATH_RE.match(p) and ".." not in p
            and not p.startswith("/") for p in paths):
        errs.append(f"paths {paths}")
    cmd = man["command"]
    if not 1 <= len(cmd) <= 32:
        errs.append("command: 1 to 32 words")
    for word in cmd:
        _line(word, f"command word {word!r}", errs)
    if not (isinstance(man["run_seconds"], int)
            and 1 <= man["run_seconds"] <= 51):
        errs.append("run_seconds: a whole number from 1 to 51")
    names: dict[str, set] = {}
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = names.setdefault(kind, set())
        for e in man[kind]:
            n = e.get("name", "")
            if not NAME_RE.match(n):
                errs.append(f"{kind} name {n!r}")
            if n in seen:
                errs.append(f"{kind} name {n!r} twice")
            seen.add(n)
    metric_names = names["end_to_end"] | names["per_layer"]
    if len(metric_names) != len(names["end_to_end"]) + len(
            names["per_layer"]):
        errs.append("a metric name is both end-to-end and per-layer")
    if not 1 <= len(man["configs"]) <= 24:
        errs.append("configs: 1 to 24")
    used = {w.get("config") for w in man["workloads"]}
    files = set()
    for c in man["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            errs.append(f"config {c.get('name')}: keys {sorted(c)}")
            continue
        _line(c["source"], f"config {c['name']} source", errs)
        _line(c["why"], f"config {c['name']} why", errs)
        if c["file"] in files or not any(
                c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            errs.append(f"config {c['name']}: file {c['file']} not its own "
                        f"or not under paths")
        files.add(c["file"])
        if not (root / c["file"]).is_file():
            errs.append(f"config {c['name']}: {c['file']} missing")
        if len(c["reduced"]) > 16 or not all(
                NAME_RE.match(k) for k in c["reduced"]):
            errs.append(f"config {c['name']}: reduced {c['reduced']}")
        if c["name"] not in used:
            errs.append(f"config {c['name']} used by no cell")
    if not 1 <= len(man["workloads"]) <= 24:
        errs.append("workloads: 1 to 24")
    pairs = set()
    for w in man["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            errs.append(f"workload {w.get('name')}: keys {sorted(w)}")
            continue
        if w["config"] not in names["configs"]:
            errs.append(f"workload {w['name']}: unknown config")
        if not NAME_RE.match(w["traffic"]) or not NAME_RE.match(w["config"]):
            errs.append(f"workload {w['name']}: config / traffic name")
        if (w["config"], w["traffic"]) in pairs:
            errs.append(f"workload {w['name']}: (config, traffic) twice")
        pairs.add((w["config"], w["traffic"]))
        if w["chips"] not in (1, 4):
            errs.append(f"workload {w['name']}: chips {w['chips']}")
        _line(w["why"], f"workload {w['name']} why", errs)
        tfile = root / "bench" / "traffic" / f"{w['name']}.json"
        if not tfile.is_file():
            errs.append(f"workload {w['name']}: {tfile} missing")
        else:
            drv = json.loads(tfile.read_text()).get("driver", "")
            if not (root / "bench" / "drivers" / f"{drv}.py").is_file():
                errs.append(f"workload {w['name']}: driver {drv!r} missing")
    four = sum(w.get("chips") == 4 for w in man["workloads"])
    if four > max(1, len(man["workloads"]) // 4):
        errs.append(f"{four} cells ask for 4 chips")
    e2e = {m["name"]: m for m in man["end_to_end"]}
    if not 1 <= len(e2e) <= 16 or "setup_s" not in e2e:
        errs.append("end_to_end: 1 to 16 metrics, setup_s among them")
    if not 1 <= len(man["per_layer"]) <= 128:
        errs.append("per_layer: 1 to 128 metrics")
    cells = names["workloads"]
    for kind, allowed, extra in (("end_to_end", SOURCES_E2E, {"bound"}),
                                 ("per_layer", SOURCES,
                                  {"layer", "moves"})):
        for m in man[kind]:
            keys = {"name", "unit", "better", "source"} | extra
            if not keys <= set(m) <= keys | {"workloads"}:
                errs.append(f"{kind} {m.get('name')}: keys {sorted(m)}")
                continue
            if not UNIT_RE.match(m["unit"]):
                errs.append(f"{m['name']}: unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                errs.append(f"{m['name']}: better {m['better']!r}")
            if m["source"] not in allowed:
                errs.append(f"{m['name']}: source {m['source']!r}")
            if "workloads" in m and not set(m["workloads"]) <= cells:
                errs.append(f"{m['name']}: unknown cells {m['workloads']}")
            if ("_roofline" in m["name"] or "mfu" in m["name"]) \
                    and m["unit"] != "%":
                errs.append(f"{m['name']}: a share of a peak is in %")
            if kind == "end_to_end":
                cap = 0.25
                if not (isinstance(m["bound"], (int, float))
                        and 0.01 <= m["bound"] <= cap):
                    errs.append(f"{m['name']}: bound {m['bound']}")
            else:
                _line(m["layer"], f"{m['name']} layer", errs)
                if m["moves"] not in e2e:
                    errs.append(f"{m['name']}: moves {m['moves']!r}")
                    continue
                mine = m.get("workloads", sorted(cells))
                for c in mine:
                    if not reports(e2e[m["moves"]], c):
                        errs.append(f"{m['name']} in {c}: {m['moves']} is "
                                    f"not reported there")
                if not (root / "bench" / "metrics"
                        / f"{m['name']}.py").is_file():
                    errs.append(f"{m['name']}: no reader file")
    for c in cells:
        own = [m for m in man["end_to_end"] if reports(m, c)]
        if len(own) < 2 or not any(m["name"] == "setup_s" for m in own):
            errs.append(f"{c}: setup_s and one more end-to-end metric")
        if not any(reports(m, c) for m in man["per_layer"]):
            errs.append(f"{c}: no per-layer metric")
    if len(json.dumps(man)) > 64 * 1024:
        errs.append("manifest over 64 KiB")
    return errs
