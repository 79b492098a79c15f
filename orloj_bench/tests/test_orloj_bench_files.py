"""``BENCHMARK.json`` and the files it names: the contract's characters and
limits, and a file of its own for every part a cell reads."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["orloj_bench"]


def test_names_and_units_use_the_allowed_characters():
    names = [m["name"] for m in METRICS] + [c["name"] for c in BENCH["configs"]]
    names += [w[k] for w in BENCH["workloads"] for k in ("name", "config", "traffic")]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in METRICS)
    for group in (METRICS, BENCH["configs"], BENCH["workloads"]):
        assert len({x["name"] for x in group}) == len(group)


def test_entries_have_just_the_contract_keys():
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert not [k for k in c["reduced"] if k.endswith(("_dim", "_rank", "_size"))]


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_cell_finds_its_files_and_reports_enough(w):
    from orloj_bench import harness

    cell = harness.load_cell(w["name"], BENCH)
    assert (ROOT / "traffic" / f"{w['traffic']}.json").exists()
    assert {"rate_rps", "slo_ms", "mix"} <= set(cell.traffic)
    assert "setup_s" in {m["name"] for m in cell.end_to_end} and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in {e["name"] for e in cell.end_to_end}


def test_every_metric_has_a_reader_and_every_file_is_used():
    for m in METRICS:
        assert (ROOT / "metrics" / f"{m['name']}.py").exists(), m["name"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("orloj_bench/") and (ROOT.parent / c["file"]).exists()
        assert (ROOT / "checks" / f"{c['name']}.json").exists()
        pattern = json.loads((ROOT.parent / c["file"]).read_text())["block_pattern"]
        assert (ROOT / "families" / f"{pattern}.py").exists(), pattern
        assert (ROOT / "reference" / f"{pattern}.py").exists(), pattern


def _bench_with(tmp_path, cfg: dict) -> dict:
    """BENCHMARK.json with the first cell's configuration replaced by ``cfg``."""
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"][0]["file"] = str(path)
    return bench


def test_an_unknown_block_pattern_fails_in_load_cell_naming_both_files(tmp_path):
    from orloj_bench import harness

    c = BENCH["configs"][0]
    cfg = json.loads((ROOT.parent / c["file"]).read_text()) | {"block_pattern": "nosuch"}
    cell = next(w["name"] for w in BENCH["workloads"] if w["config"] == c["name"])
    with pytest.raises(SystemExit) as e:
        harness.load_cell(cell, _bench_with(tmp_path, cfg))
    assert "orloj_bench/families/nosuch.py" in str(e.value)
    assert "orloj_bench/reference/nosuch.py" in str(e.value)


def test_a_configuration_may_set_the_engines_shapes(tmp_path):
    from orloj_bench import harness
    from repro_torch.serving.engine import EngineConfig

    c = BENCH["configs"][0]
    cfg = json.loads((ROOT.parent / c["file"]).read_text())
    assert "engine" not in cfg and harness.engine_config(cfg) == EngineConfig()
    cfg["engine"] = {"buckets": [256, 512, 1024], "batch_sizes": [1, 2]}
    cell = next(w["name"] for w in BENCH["workloads"] if w["config"] == c["name"])
    engine = harness.engine_config(harness.load_cell(cell, _bench_with(tmp_path, cfg)).config)
    assert engine == EngineConfig(buckets=(256, 512, 1024), batch_sizes=(1, 2))


@pytest.mark.parametrize("key", ["profile_reps", "batch_timeout_ms", "nosuch"])
def test_a_configuration_may_set_no_other_engine_field(key, tmp_path):
    from orloj_bench import harness

    c = BENCH["configs"][0]
    cfg = json.loads((ROOT.parent / c["file"]).read_text())
    cfg["engine"] = {"buckets": [32, 64], key: 1}
    cell = next(w["name"] for w in BENCH["workloads"] if w["config"] == c["name"])
    with pytest.raises(SystemExit, match=f"sets engine {key};"):
        harness.load_cell(cell, _bench_with(tmp_path, cfg))
    with pytest.raises(SystemExit, match=f"sets engine {key};"):
        harness.engine_config(cfg)
