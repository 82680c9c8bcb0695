"""``BENCHMARK.json`` against the rules of its format, and the harness
finding a configuration, a mix and a metric by name alone (CPU)."""

import ast
import json
import os
import re
import shutil

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", *KEYS}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32
    assert all(LINE.match(w) for w in SPEC["command"])
    for group, lo, hi in (("configs", 1, 24), ("workloads", 1, 24),
                          ("end_to_end", 1, 16), ("per_layer", 1, 128)):
        assert lo <= len(SPEC[group]) <= hi


@pytest.mark.parametrize("group", sorted(KEYS))
def test_entries_have_their_keys_and_allowed_names(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(names) == len(set(names))
    for e in SPEC[group]:
        extra = {"workloads"} if group in ("end_to_end", "per_layer") else set()
        assert KEYS[group] <= set(e) <= KEYS[group] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                              "higher")
        for k in ("why", "layer") + (("source",) if group == "configs"
                                     else ()):
            if k in e:
                assert LINE.match(e[k]), (e["name"], k)
        for k in ("config", "traffic"):
            if k in e:
                assert NAME.match(e[k])


def test_metrics_and_cells_fit_together():
    cells = {w["name"] for w in SPEC["workloads"]}
    configs = {c["name"]: c for c in SPEC["configs"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        moved = e2e[m["moves"]].get("workloads", cells)
        assert set(m.get("workloads", cells)) <= set(moved)
    for w in SPEC["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        reports = [m for m in SPEC["end_to_end"]
                   if w["name"] in m.get("workloads", cells)]
        assert len(reports) >= 2  # setup_s and one more
        assert any(w["name"] in m.get("workloads", cells)
                   for m in SPEC["per_layer"])
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {w["config"] for w in SPEC["workloads"]} == set(configs)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_every_name_has_its_file():
    bench = os.path.join(ROOT, "benchmark")
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/")
        conf = harness.load_json(os.path.join(ROOT, c["file"]))
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert "guarantees" in conf and "assumed" in conf
    for w in SPEC["workloads"]:
        mix = harness.load_json(os.path.join(bench, "traffic",
                                             w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(bench, "ops", mix["op"] + ".py"))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert os.path.exists(os.path.join(bench, "metrics",
                                           m["name"] + ".py"))


def test_file_names_under_paths_are_made_of_name_characters():
    bad = []
    for p in SPEC["paths"]:
        for dirpath, dirs, files in os.walk(os.path.join(ROOT, p)):
            dirs[:] = [d for d in dirs if d not in ("build", "__pycache__")]
            for f in dirs + files:
                if not NAME.match(f):
                    bad.append(os.path.join(dirpath, f))
    assert not bad


def test_a_dropped_in_config_mix_and_metric_are_found_by_name(tmp_path):
    """A new configuration, traffic mix and per-layer metrics are new files
    and entries only: the harness finds them by name and a run reports
    the new metrics, one of the trace and one of the port's spans, no
    other file edited."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    conf = harness.load_json(os.path.join(ROOT, spec["configs"][0]["file"]))
    conf.update(name="tiny-web", graph=dict(
        conf["graph"], nodes=4000, hubs={"lengths": [60, 120]}))
    (tmp_path / "benchmark/configs/tiny-web.json").write_text(
        json.dumps(conf))
    (tmp_path / "benchmark/traffic/decode-few.json").write_text(json.dumps(
        {"op": "decode", "warmup_calls": 1,
         "check": {"sample": 1, "among": 2}}))
    (tmp_path / "benchmark/metrics/calls_traced.py").write_text(
        "def read(run):\n    return float(len(run.trace.spans))\n")
    (tmp_path / "benchmark/metrics/calls_spanned.py").write_text(
        "def read(run):\n"
        "    if not run.spans:\n"
        "        return None\n"
        "    return float(sum(s.parent is None for s in run.spans))\n")
    spec["configs"].append({"name": "tiny-web", "source": "https://x.org",
                            "file": "benchmark/configs/tiny-web.json",
                            "reduced": ["nodes"], "why": "a test"})
    spec["workloads"].append({"name": "tiny-web.decode-few",
                              "config": "tiny-web", "traffic": "decode-few",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "calls_traced", "unit": "calls",
                              "better": "higher", "source": "program_span",
                              "layer": "harness", "moves": "setup_s",
                              "workloads": ["tiny-web.decode-few"]})
    spec["per_layer"].append({"name": "calls_spanned", "unit": "calls",
                              "better": "higher", "source": "program_span",
                              "layer": "decode wrapper", "moves": "setup_s",
                              "workloads": ["tiny-web.decode-few"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.find_cell("tiny-web.decode-few", root=str(tmp_path))
    assert cell.config["graph"]["nodes"] == 4000
    assert cell.mix["check"]["among"] == 2
    r = harness.run_cell(cell, 5, 0.05, True, "cpu", 0.0)
    assert r["correct"] and r["metrics"]["calls_traced"]["value"] >= 1
    # every traced call is one top-level span of the port's
    assert r["metrics"]["calls_spanned"]["value"] == \
        r["metrics"]["calls_traced"]["value"]
    # a CPU trace holds no device activity: no device metric is read
    assert set(r["metrics"]) == {"calls_traced", "calls_spanned"}


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell("no-such.cell")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_and_the_reference_imports_no_port():
    """Top-level names compared whole: the port's name begins with the JAX
    package's."""
    bench = os.path.join(ROOT, "benchmark")
    for dirpath, dirs, files in os.walk(bench):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            names = set(_imports(path))
            assert not names & {"jax", "jaxlib", "flax", "webgraph_tpu"}, path
            if os.path.basename(dirpath) == "reference":
                assert "webgraph_tpu_torch" not in names, path
