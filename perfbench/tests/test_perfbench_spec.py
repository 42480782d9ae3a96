"""BENCHMARK.json against the benchmark's contract, and every piece of
every cell found by its name."""

import json
import re

from pbench import check, spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

BENCH = spec.benchmark()
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _names():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


def test_keys():
    assert set(BENCH) == TOP
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and not {"\n", "\t"} & set(text)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"


def test_names_and_units():
    names = list(_names())
    assert all(NAME.match(n) for n in names), names
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        group_names = [e["name"] for e in BENCH[group]]
        assert len(set(group_names)) == len(group_names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                              "higher")
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_piece_found_by_name():
    for w in BENCH["workloads"]:
        cell = spec.resolve(w["name"])
        assert cell.config["name"] == w["config"]
        assert {"scenarios", "frames", "check_scenarios"} <= set(cell.traffic)
        assert set(cell.limits) <= set(check.NUMBERS)
        assert {"feat_mismatch", "odom_gap_m", "rot_gap_rad",
                "mapped_mismatch"} <= set(cell.limits)
        assert cell.config["azimuths"] > 0 and cell.config["scan_period"] > 0
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_reduced_keys_are_in_the_config_file():
    for c in BENCH["configs"]:
        data = spec.load_json(spec.ROOT / c["file"])
        assert data["reduced"] == c["reduced"]
        assert set(c["reduced"]) <= set(data)
        assert data["source"] == c["source"]
