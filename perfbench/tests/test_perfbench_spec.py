"""BENCHMARK.json against the contract it is written to, and every file it
names found by name; a new cell from new files only."""
import hashlib
import json
import re

import pytest

from perfbench.spec import HERE, Spec

ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"] + metrics]
    assert all(NAME.match(n) for n in names)
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(x["why"]) <= 200 and "\n" not in x["why"] and "\t" not in x["why"]
    for c in BENCH["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/") and (ROOT / c["file"]).is_file()
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(CELLS)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS and cell in moved.get("workloads", CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell):
    c = Spec(ROOT / "BENCHMARK.json").cell(cell)
    kinds = {m.name for m in c.metrics["end_to_end"]}
    assert {"setup_s", "train_tokens_per_s", "peak_mem_gb"} <= kinds
    assert c.metrics["per_layer"] and all(callable(m.read) for m in c.metrics["per_layer"])
    config = json.loads((ROOT / [x for x in BENCH["configs"] if x["name"] == c.config_name][0]
                         ["file"]).read_text())
    assert set(config["reduced"]) == set(
        [x for x in BENCH["configs"] if x["name"] == c.config_name][0]["reduced"])
    limits = {k: v for k, v in c.limits.items() if k != "readings"}
    assert limits and all(v is None or v >= 0 for v in limits.values())
    assert set(limits) <= set(c.limits["readings"])


def test_a_new_cell_is_new_files_only(tiny):
    before = {p: hashlib.sha256(p.read_bytes()).hexdigest()
              for p in HERE.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    cell = tiny.cell("tiny.refresh")
    assert cell.config["hidden_size"] == 64 and cell.traffic["docs"] == 32
    assert "window_steps" in {m.name for m in cell.metrics["per_layer"]}
    # the repository's own readers serve the new cell too
    assert {"train_tokens_per_s", "coreset_s"} <= {m.name for m in cell.metrics["end_to_end"]}
    after = {p: hashlib.sha256(p.read_bytes()).hexdigest()
             for p in HERE.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    assert after == before


def test_a_missing_file_is_named(tiny):
    bench = json.loads(tiny.path.read_text())
    bench["workloads"].append({"name": "tiny.nomix", "config": "tiny", "traffic": "absent",
                               "chips": 1, "why": "a CPU test"})
    other = tiny.root / "BENCHMARK.nomix.json"
    other.write_text(json.dumps(bench))
    with pytest.raises(FileNotFoundError, match="traffic/absent.json"):
        Spec(other, search=tiny.search).cell("tiny.nomix")


def test_a_mix_key_no_runner_reads_is_refused(tiny):
    bench = json.loads(tiny.path.read_text())
    bench["workloads"].append({"name": "tiny.stream", "config": "tiny",
                               "traffic": "tiny_stream", "chips": 1, "why": "a CPU test"})
    mix = json.loads((tiny.search[0] / "traffic" / "tiny_refresh.json").read_text())
    (tiny.search[0] / "traffic" / "tiny_stream.json").write_text(
        json.dumps({**mix, "streaming_ingest": True}))
    other = tiny.root / "BENCHMARK.stream.json"
    other.write_text(json.dumps(bench))
    with pytest.raises(ValueError, match=r"does not read \['streaming_ingest'\]"):
        Spec(other, search=tiny.search).cell("tiny.stream")


ECHO_RUNNER = '''"""A runner added by a new file: no program, fixed numbers."""
import types

MIX_KEYS = frozenset({"steps"})
PLANTS = ()


def run(cell, seed, seconds, trace, device, t_start, plant=None, log=print):
    steps = [{"time_s": 0.5}] * cell.traffic["steps"]
    run = types.SimpleNamespace(setup_s=1.0, window_s=2.0, peak_bytes=0, trace=None,
                                steps=steps, tokens_per_step=10, model_flops=0.0,
                                peaks={"bf16_flops": 1.0})
    return types.SimpleNamespace(run=run, numbers={"echo_gap": 0.0}, shown={},
                                 attempted=len(steps), failed=0)
'''


def test_a_new_kind_of_cell_is_a_new_runner_file(tiny):
    import time

    from perfbench.harness import run_cell

    data = tiny.search[0]
    (data / "runners").mkdir(exist_ok=True)
    (data / "runners" / "echo_test.py").write_text(ECHO_RUNNER)
    (data / "traffic" / "echo.json").write_text(json.dumps({"runner": "echo_test", "steps": 4}))
    (data / "limits" / "tiny.echo.json").write_text(json.dumps({"echo_gap": 0}))
    bench = json.loads(tiny.path.read_text())
    bench["workloads"].append({"name": "tiny.echo", "config": "tiny", "traffic": "echo",
                               "chips": 1, "why": "a CPU test"})
    other = tiny.root / "BENCHMARK.echo.json"
    other.write_text(json.dumps(bench))
    result, lines, _ = run_cell(Spec(other, search=tiny.search), "tiny.echo", 1, 0.1, False,
                                "cpu", time.perf_counter(), log=lambda s: None)
    assert result["correct"] and result["attempted"] == 4
    assert result["metrics"]["train_tokens_per_s"]["value"] == 20.0
    assert result["check"] == {"echo_gap": {"value": 0.0, "limit": 0.0}} and len(lines) == 1


def test_departures_are_stated_apart_from_the_cut():
    from perfbench.model_shape import Shape

    c = json.loads((HERE / "configs" / "granite-3-8b.json").read_text())
    assert list(c["reduced"]) == ["num_hidden_layers"]
    assert c["tie_word_embeddings"] is True and c["logits_scaling"] == 16.0
    s = Shape.from_config("granite-3-8b", c)
    assert not s.tied and s.n_layers == 12 and s.head_dim == 128
    with pytest.raises(ValueError, match="logits_scaling"):
        Shape.from_config("granite-3-8b", {**c, "as_run": {
            k: v for k, v in c["as_run"].items() if k != "logits_scaling"}})
