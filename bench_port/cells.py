"""Finding a cell's pieces by the names in BENCHMARK.json: its
configuration (configs/<config>.json), its traffic mix
(traffic/<traffic>.json), the format module that makes and decodes its
captures (formats/<format>.py, named by the configuration) and each
metric's reader (metrics/<metric>.py, a `read(rec)` that returns a number
or None). A later cell, configuration, mix or metric is new files and
entries; no file here names one."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def format_module(name: str):
    """formats/<name>.py, imported as a module of this package."""
    import importlib
    if not (HERE / "formats" / f"{name}.py").is_file():
        raise FileNotFoundError(f"no bench_port/formats/{name}.py")
    return importlib.import_module(f"bench_port.formats.{name}")


def metric_reader(name: str):
    """The `read` function of metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    return _module(path, "bench_port_metric_" + name.replace(".", "_")).read


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic and
    metrics resolved."""

    def __init__(self, bench: dict, name: str, root=ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.workload = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        entry = configs[self.workload["config"]]
        self.config = load_json(Path(root) / entry["file"])
        self.traffic = load_json(HERE / "traffic"
                                 / f"{self.workload['traffic']}.json")
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if self._reports(m)]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in moved)]

    def _reports(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]

    def metrics(self, trace: bool):
        return self.per_layer if trace else self.end_to_end
