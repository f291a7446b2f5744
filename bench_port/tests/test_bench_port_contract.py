"""BENCHMARK.json keeps to the benchmark contract's form, every name it
gives resolves to a file, and a cell added as new files only is found."""
import json
import re
import shutil

import pytest

from bench_port import cells

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_./-]{1,200}")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_names_units_and_lengths():
    raw = (cells.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024
    b = json.loads(raw)
    assert set(b) == TOP
    assert 1 <= len(b["command"]) <= 32 and all(map(one_line, b["command"]))
    assert all(PATH.fullmatch(p) and ".." not in p for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and one_line(c["source"])
        assert one_line(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.fullmatch(k) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in b["paths"]))
        names.add(c["name"])
    assert len(names) == len(b["configs"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.fullmatch(w["name"]) and NAME.fullmatch(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert one_line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])
    cellnames = {w["name"] for w in b["workloads"]}
    metric_names = []
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        metric_names.append(m["name"])
    assert "setup_s" in metric_names
    e2e = set(metric_names)
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert one_line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cellnames)) <= cellnames
        metric_names.append(m["name"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
    assert len(set(metric_names)) == len(metric_names)


def test_every_cell_resolves_and_reports_what_it_must():
    b = cells.benchmark()
    for w in b["workloads"]:
        cell = cells.Cell(b, w["name"])
        cells.format_module(cell.config["format"])
        e2e = {m["name"] for m in cell.metrics(False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.metrics(True)
        for m in cell.metrics(False) + cell.metrics(True):
            assert callable(cells.metric_reader(m["name"]))
        assert set(cell.traffic["limits"]) == {
            "wrong_share", "wrong_intact_share", "missing_wavs"}


def test_a_cell_added_as_new_files_only_is_found(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(cells.HERE, root / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = cells.benchmark()
    # New files: a configuration, a mix, a per-layer metric.
    cfg = json.loads((cells.HERE / "configs" / "stc007_pal_normal.json")
                     .read_text())
    cfg["name"] = "stc007_pal_fast"
    cfg["decoder"]["kwargs"].update(hyst_limit=2, shift_limit=1)
    (root / "bench_port" / "configs" / "stc007_pal_fast.json").write_text(
        json.dumps(cfg))
    mix = json.loads((cells.HERE / "traffic" / "tapes8.json").read_text())
    mix["frames"] = [256, 1024]
    (root / "bench_port" / "traffic" / "tape1.json").write_text(
        json.dumps(dict(mix, captures_per_run=1)))
    (root / "bench_port" / "metrics" / "runs_per_s.py").write_text(
        "def read(rec):\n    return rec.runs / rec.window_s\n")
    # New entries in BENCHMARK.json.
    bench["configs"].append(dict(
        name="stc007_pal_fast", source="https://example.org/fast",
        file="bench_port/configs/stc007_pal_fast.json", reduced=[],
        why="fast"))
    bench["workloads"].append(dict(
        name="stc007_pal_fast.tape1", config="stc007_pal_fast",
        traffic="tape1", chips=1, why="one long tape"))
    bench["per_layer"].append(dict(
        name="runs_per_s", unit="1/s", better="higher",
        source="host_clock", layer="harness", moves="frames_per_s",
        workloads=["stc007_pal_fast.tape1"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(cells, "HERE", root / "bench_port")
    cell = cells.Cell(cells.benchmark(root), "stc007_pal_fast.tape1",
                      root=root)
    assert cell.config["decoder"]["kwargs"]["hyst_limit"] == 2
    assert cell.traffic["captures_per_run"] == 1
    per_layer = [m["name"] for m in cell.metrics(True)]
    assert "runs_per_s" in per_layer and "k1_roofline" not in per_layer
    rec = type("R", (), dict(runs=6, window_s=3.0))()
    assert cells.metric_reader("runs_per_s")(rec) == 2.0
    old = cells.Cell(cells.benchmark(root), "stc007_pal_normal.tapes8",
                     root=root)
    assert "runs_per_s" not in [m["name"] for m in old.metrics(True)]


@pytest.mark.parametrize("name", ["frames_per_s", "setup_s"])
def test_end_to_end_metrics_are_host_clock(name):
    m = {x["name"]: x for x in cells.benchmark()["end_to_end"]}[name]
    assert m["source"] == "host_clock"
