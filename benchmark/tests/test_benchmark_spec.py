"""BENCHMARK.json against the benchmark's contract, and the files it names."""

import ast
import json
import re
from pathlib import Path

import pytest

from benchmark import metrics, spec

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\n\t]{1,200}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|projection|head|expansion|_dim$|_rank$|"
                    r"experts_per_tok)")
ALL_METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(TEXT.match(w) for w in BENCH["command"])
    assert BENCH["paths"] == ["benchmark"]
    for w in BENCH["command"]:
        assert not w.startswith("/") and ".." not in w


def test_run_seconds_fits_the_check_with_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + ALL_METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_text(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert TEXT.match(entry[key])
    for k in entry.get("reduced", []):
        assert NAME.match(k) and not WIDTHS.search(k)


def test_entries_have_only_their_keys_and_unique_names():
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound", "source"}),
                        ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names)), group
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == keys, e["name"]
    all_names = [m["name"] for m in ALL_METRICS]
    assert len(all_names) == len(set(all_names))


def test_cells_and_configurations():
    cfg_names = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == cfg_names
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).exists()
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["source"] == c["source"] and c["source"].startswith("https://")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_and_reports_what_the_contract_asks(name):
    cell = spec.cell(BENCH, name)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    assert cell["traffic_data"]["loop"] in ("offline", "frames")
    for m in cell["per_layer"]:
        assert m["moves"] in e2e


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]


@pytest.mark.parametrize("m", ALL_METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader_that_agrees(m):
    mod = metrics.load(m["name"])
    assert mod.SOURCE == m["source"]
    assert mod.LAYER == m.get("layer") and mod.MOVES == m.get("moves")
    if m["unit"] == "%" and ("roofline" in m["name"] or "mfu" in m["name"]):
        assert m["better"] == "higher"


def test_layers_are_named_as_perf_md_lists_them():
    perf = (REPO / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def _sources():
    return sorted(p for p in (REPO / "benchmark").rglob("*.py") if "tests" not in p.parts)


def test_the_harness_reads_none_of_the_jax_benchmarks_records():
    banned = ("BENCH_r", "MULTICHIP_", "BASELINE.json", "bench.py")
    for p in _sources() + sorted((REPO / "benchmark").rglob("*.json")):
        text = p.read_text()
        for b in banned:
            assert b not in text, (p, b)


def test_the_reference_imports_nothing_of_the_program_or_jax():
    for p in sorted((REPO / "benchmark" / "reference").glob("*.py")):
        tree = ast.parse(p.read_text())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            for mod in mods:
                assert mod.split(".")[0] in ("numpy", "torch", "math", "typing", "__future__"), \
                    (p.name, mod)


def test_no_harness_module_imports_jax():
    for p in _sources():
        tree = ast.parse(p.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax", "raytrace_tpu"), (p, n)
