"""BENCHMARK.json against the form it must have, and the files it names."""

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
BENCH = spec.load_benchmark()


def line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and line(w["why"])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    all_names = [m["name"] for m in metrics]
    cells = [w["name"] for w in BENCH["workloads"]]
    for group in (names, cells, all_names):
        assert len(group) == len(set(group))
    assert "setup_s" in all_names
    assert {w["config"] for w in BENCH["workloads"]} == set(names)


def test_every_cell_has_its_files_and_metrics():
    for w in BENCH["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert {"num_envs"} <= set(cell.traffic)
        assert set(cell.settings) == {"reference_iterations",
                                      "trace_iterations", "limits",
                                      "limits_from"}
        assert set(cell.settings["limits"]) == {"loss_gap", "grad_gap",
                                                "update_gap"}
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
        for m in cell.end_to_end + cell.per_layer:
            assert os.path.exists(os.path.join(spec.BENCH, "metrics",
                                               m["name"] + ".py"))
        ref = os.path.join(spec.BENCH, "reference",
                           cell.config["reference"] + ".py")
        assert os.path.exists(ref)
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", [])) <= {w["name"]
                                               for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(spec.ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_a_new_cell_needs_only_new_files(tmp_path):
    """A copy of the benchmark with one cell more, added as a traffic file,
    a cell file and an entry of BENCHMARK.json, loads and builds its run
    configuration with every existing file unchanged."""
    import shutil

    shutil.copytree(spec.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_out", "_cache",
                                                  "__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append(
        {"name": "drift_mushr_mlp.envs_1024", "config": "drift_mushr_mlp",
         "traffic": "envs_1024", "chips": 1, "why": "the named config"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark/traffic/envs_1024.json").write_text(
        json.dumps({"num_envs": 1024}))
    cell_file = tmp_path / "benchmark/workloads/drift_mushr_mlp.envs_1024.json"
    cell_file.write_text((tmp_path / "benchmark/workloads"
                          / "drift_mushr_mlp.envs_65536.json").read_text())
    code = ("from benchmark import spec, harness; "
            "c = spec.load_cell('drift_mushr_mlp.envs_1024'); "
            "r = harness.run_config(c, 5, 'cpu'); "
            "print(r.num_envs, r.task_name, [m['name'] for m in c.per_layer])")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{spec.ROOT}")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, check=True).stdout
    assert out.startswith("1024 MushrDriftRL-v0")
    assert "k1_roofline_pct" not in out


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_run_config_is_the_configuration(name):
    from benchmark import harness

    cell = spec.load_cell(name)
    rc = harness.run_config(cell, 7, "cpu")
    assert rc.num_envs == cell.num_envs
    assert rc.train.distributed == "off" and rc.train.seed == 7
    for k, v in cell.agent.items():
        assert getattr(rc.agent, k) == (tuple(v) if isinstance(v, list)
                                        else v)


def test_the_kept_elevation_cell_loads_from_its_files():
    """The elevation cell that BENCHMARK.json leaves out keeps files that
    load as a cell: a later entry in BENCHMARK.json is all it needs."""
    from benchmark import harness
    from benchmark.tests.conftest import ELEVATION

    cell = spec.cell_of(ELEVATION, BENCH)
    assert cell.config["name"] == ELEVATION["config"]
    assert set(cell.settings) == {"reference_iterations", "trace_iterations",
                                  "limits", "limits_from"}
    assert cell.config["reduced"] == [] and cell.traffic["source"]
    rc = harness.run_config(cell, 7, "cpu")
    assert (rc.num_envs, rc.task_name) == (4096, "MushrElevationRL-v0")
    assert os.path.exists(os.path.join(spec.BENCH, "reference",
                                       cell.config["reference"] + ".py"))
