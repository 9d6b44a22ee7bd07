"""``BENCHMARK.json`` against the static rules a benchmark file keeps:
keys, names, units, files under ``paths``, and what every cell must
report."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer",
                      "moves", "workloads"}}
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|"
                   r"_dim$|_rank$|experts_per|top_k|d_model|d_ff|d_head)")


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["bench"]
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_text(w) for w in SPEC["command"])
    for w in SPEC["command"][1:]:
        assert not w.startswith("/") and ".." not in w
        if "/" in w:
            assert w.split("/")[0] in SPEC["paths"] and (ROOT / w).exists()
    assert isinstance(SPEC["run_seconds"], int) \
        and 1 <= SPEC["run_seconds"] <= 51
    n = 24                        # the budget holds with the full 24 cells
    assert (2 + 14 * n) * (SPEC["run_seconds"] + 60) + n * 180 + 1200 \
        <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        extra = {"workloads"} if kind == "end_to_end" else set()
        if kind == "per_layer":
            assert e["workloads"], e["name"]
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                             "higher")
        for k in ("why", "layer"):
            if k in e:
                assert _text(e[k]), (e["name"], k)
        if kind == "configs":
            assert _text(e["source"])


def test_configs_and_cells():
    cfgs = {c["name"]: c for c in SPEC["configs"]}
    for c in cfgs.values():
        path = ROOT / c["file"]
        assert c["file"].split("/")[0] == "bench" and path.is_file()
        data = json.loads(path.read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    used = set()
    pairs = set()
    for w in SPEC["workloads"]:
        assert w["config"] in cfgs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and _text(w["why"])
        assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "bench" / "cells" / f"{w['name']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(cfgs)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    reports = {c: {n for n, m in e2e.items()
                   if c in m.get("workloads", cells)} for c in cells}
    layers = {}
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        for c in m["workloads"]:
            assert c in cells and m["moves"] in reports[c], (m, c)
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
        layers.setdefault(m["layer"], set()).add(m["name"])
    for c in cells:
        assert "setup_s" in reports[c] and len(reports[c]) >= 2
        assert any(c in m["workloads"] for m in SPEC["per_layer"])
    # every kernel roofline has a whole-step mfu moving the same metric
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"]:
            assert any("mfu" in x["name"] and x["moves"] == m["moves"]
                       and set(m["workloads"]) <= set(x["workloads"])
                       for x in SPEC["per_layer"]), m["name"]


def test_layers_are_named_in_perf_md():
    perf = (ROOT / "PERF.md").read_text()
    for m in SPEC["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]
