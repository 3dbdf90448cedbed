"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from benchmark import core, traffic

MAN = core.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["benchmark"]
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51


def test_names_and_units():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in MAN[k]]
    for n in names:
        assert NAME.match(n), n
    for k in ("configs", "workloads"):
        assert len({x["name"] for x in MAN[k]}) == len(MAN[k])
    metrics = MAN["end_to_end"] + MAN["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for w in MAN["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 0 < len(w["why"]) <= 200


def test_end_to_end_bounds():
    names = {m["name"]: m for m in MAN["end_to_end"]}
    assert names["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_what_it_needs():
    for w in MAN["workloads"]:
        e2e = {m["name"] for m in core.cell_metrics(MAN, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        layer = core.cell_metrics(MAN, w["name"], True)
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_per_layer_metrics_name_real_cells():
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert set(m["workloads"]) <= cells, m["name"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_metric_reader_found_by_name(metric):
    assert callable(core.reader(metric))


@pytest.mark.parametrize("cfg", [c["name"] for c in MAN["configs"]])
def test_config_and_reference_found_by_name(cfg):
    entry = next(c for c in MAN["configs"] if c["name"] == cfg)
    assert entry["file"] == f"benchmark/configs/{cfg}.json"
    data, ref = core.config(MAN, cfg)
    assert data["name"] == cfg and data["limits"]
    assert entry["reduced"] == []
    spec = ref.param_spec(data)
    assert len({n for n, _, _, _ in spec}) == len(spec)


@pytest.mark.parametrize("mix", sorted({w["traffic"]
                                        for w in MAN["workloads"]}))
def test_traffic_found_by_name(mix):
    data = traffic.load(mix)
    assert (core.HERE / "kinds" / f"{data['kind']}.py").is_file()


def test_manifest_is_small():
    assert len(json.dumps(MAN)) < 64 * 1024
