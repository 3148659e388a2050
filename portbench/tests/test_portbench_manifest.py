"""BENCHMARK.json against the contract it is written to: every entry
resolves to its files, and every name, unit and bound is well formed."""

import json
import re

import pytest

from portbench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
MANIFEST = json.loads((core.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def test_top_level_keys_and_size():
    assert set(MANIFEST) == KEYS
    assert (core.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert MANIFEST["paths"] == ["portbench"]
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51


def test_a_full_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (MANIFEST["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_texts():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), names
    texts = ([e["why"] for e in MANIFEST["configs"] + MANIFEST["workloads"]]
             + [m["layer"] for m in MANIFEST["per_layer"]]
             + [c["source"] for c in MANIFEST["configs"]])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    allowed = {"configs": {"name", "source", "file", "reduced", "why"},
               "workloads": {"name", "config", "traffic", "chips", "why"},
               "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
               "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for group, keys in allowed.items():
        for e in MANIFEST[group]:
            assert set(e) <= keys, (group, set(e) - keys)


@pytest.mark.parametrize("config", MANIFEST["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    path = core.ROOT / config["file"]
    assert config["file"].startswith("portbench/configs/") and path.exists()
    data = json.loads(path.read_text())
    assert data["name"] == config["name"]
    assert config["source"].startswith("https://") and data["source"] == config["source"]
    assert len(config["reduced"]) <= 16 and all(NAME.match(k) for k in config["reduced"])
    assert (core.HERE / "reference" / f"{data['reference']}.py").exists()
    assert any(w["config"] == config["name"] for w in MANIFEST["workloads"])


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_to_its_files(name):
    cell = core.resolve_cell(name)
    assert cell.chips in (1, 4)
    assert (core.HERE / "drivers" / f"{cell.traffic['driver']}.py").exists()
    assert core.driver(cell).run
    assert cell.limits["limits"]
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in reported, (m["name"], m["moves"])
        assert callable(core.metric_reader(m["name"]).read)


def test_cells_pairs_chips_and_metrics():
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert all(len(v) == 1 for v in layers.values())
