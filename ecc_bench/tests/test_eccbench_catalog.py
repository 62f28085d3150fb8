"""``BENCHMARK.json`` against the contract's shape, and every name in it
found as a file."""
import json
import re

import pytest

from ecc_bench import catalog

BENCH = catalog.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = catalog.names(BENCH)


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_configs_and_cells():
    names = [c["name"] for c in BENCH["configs"]]
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"ecc_bench/configs/{c['name']}.json"
        assert json.loads((catalog.ROOT / c["file"]).read_text())["name"] \
            == c["name"]
        assert len(c["reduced"]) <= 16
    pairs = set()
    four = 0
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
    assert len(pairs) == len(BENCH["workloads"]) == len(set(CELLS))
    assert four <= max(1, len(CELLS) // 4)
    assert {w["config"] for w in BENCH["workloads"]} == set(names)


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.add(m["layer"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files(name):
    cell = catalog.cell(name)
    assert cell.config["config"]["name"] == cell.entry["config"]
    assert cell.traffic["loop"] == "closed"
    assert isinstance(cell.traffic["wire_steps"], int)
    assert cell.traffic["wire_steps"] >= 1
    assert callable(cell.loop.window)
    assert callable(cell.server.make)
    assert all(callable(getattr(cell.family, f)) for f in (
        "Inputs", "reference", "per_request", "numbers", "as_control"))
    assert {"limit", "lower", "upper"} <= set(cell.limits["payload_err"])
    head = cell.config["config"]["vla_action_head"]
    assert set(cell.limits) == ({"payload_err", "logit_gap"}
                                if head == "detok" else
                                {"payload_err", "action_err", "chunk_err"})
    for e in cell.limits.values():     # each limit between its readings
        assert e["lower"] < e["limit"] < e["upper"]
        assert e["upper"] >= 3 * e["lower"]
    assert any(m["name"] != "setup_s" for m in cell.end_to_end)
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.metric_reader(m["name"]).read)


def test_unknown_cell():
    with pytest.raises(KeyError):
        catalog.cell("no-such.cell")


@pytest.mark.parametrize("kind", ["families", "servers", "loops", "metrics"])
def test_unknown_module_of_each_kind(kind):
    with pytest.raises(KeyError, match="is missing"):
        catalog.plugin(kind, "no-such-module")


def test_a_module_is_loaded_once_by_its_path():
    a = catalog.plugin("loops", "closed")
    assert catalog.plugin("loops", "closed") is a
    assert a.__file__ == str(catalog.HERE / "loops" / "closed.py")
