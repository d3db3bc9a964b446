"""The benchmark's cells resolve by name, new files are found without code,
and a run loads neither JAX nor the JAX package (CPU only)."""
import json
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

from portbench import cells, harness

ROOT = cells.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    return cells.benchmark()


def test_benchmark_file_is_well_formed():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    assert b["paths"] == ["portbench"]
    assert b["command"] == ["python3", "portbench/run.py"]
    used = {c["config"] for c in b["workloads"]}
    assert used == {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  cells.benchmark()["workloads"]])
def test_every_cell_resolves_to_its_files(cell):
    b = _bench()
    w = cells.cell(cell, b)
    cfg = cells.config(w["config"], b)
    entry = next(c for c in b["configs"] if c["name"] == w["config"])
    assert cfg["name"] == w["config"] and cfg["reduced"] == entry["reduced"]
    layers = cells.reference(cfg["reference"]).layers(
        cfg["img"], cfg["num_classes"], cfg["in_channels"])
    assert layers[0][1] == "input" and layers[-1][1] == "softmax"
    traffic = cells.traffic(w["traffic"])
    assert callable(cells.load(traffic["loop"]))
    assert "prob_gap" in cfg["check"]
    metrics = cells.per_layer(cell, b)
    assert metrics
    for m in metrics:
        assert callable(cells.reader(m["name"]))


def test_new_traffic_config_and_metric_files_are_found(tmp_path):
    """A later change adds a cell by adding files and entries only."""
    b = _bench()
    here = tmp_path / "portbench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(cells.HERE / sub, here / sub)
    cfg = json.loads((cells.HERE / "configs" / "vgg16-224.zu2.json")
                     .read_text())
    cfg["name"] = "vgg16-192.zu2"
    cfg["img"] = 192
    (here / "configs" / "vgg16-192.zu2.json").write_text(json.dumps(cfg))
    (here / "traffic" / "online-q16.json").write_text(json.dumps(
        {"loop": "poisson", "rate": 800.0, "images_per_request": 1,
         "max_batch": 8, "max_latency_s": 0.002, "pool": 64}))
    shutil.copytree(cells.HERE / "loads", here / "loads")
    (here / "loads" / "poisson.py").write_text(
        "class Load:\n    kind = 'open'\n")
    (here / "metrics" / "pad_share.py").write_text(
        "def read(run):\n    return 42.0\n")
    b["configs"].append({"name": "vgg16-192.zu2", "source": "x",
                         "file": "portbench/configs/vgg16-192.zu2.json",
                         "reduced": ["img"], "why": "x"})
    b["workloads"].append({"name": "vgg16-192.zu2.online-q16",
                           "config": "vgg16-192.zu2", "traffic": "online-q16",
                           "chips": 1, "why": "x"})
    b["per_layer"].append({"name": "pad_share", "unit": "%",
                           "better": "lower", "source": "program_counter",
                           "layer": "serving", "moves": "images_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))

    b2 = cells.benchmark(tmp_path)
    w = cells.cell("vgg16-192.zu2.online-q16", b2)
    assert cells.config(w["config"], b2, tmp_path)["img"] == 192
    traffic = cells.traffic(w["traffic"], here)
    assert traffic["rate"] == 800.0
    assert cells.load(traffic["loop"], here).kind == "open"
    names = [m["name"] for m in cells.per_layer(w["name"], b2)]
    assert names == ["pad_share"]
    assert cells.reader("pad_share", here)(None) == 42.0


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("repro_torch_extra", "jaxlike", "reproduce"):
        monkeypatch.setitem(sys.modules, name, object())
    assert not set(harness.forbidden_modules()) & {"jaxlike", "reproduce"}
    monkeypatch.setitem(sys.modules, "repro.core", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert {"repro", "jax"} <= set(harness.forbidden_modules())


def _env():
    return dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
                CUDA_VISIBLE_DEVICES="")


def test_setup_path_loads_neither_jax_nor_the_jax_package():
    """Each cell's set-up path on the CPU at a small size: inputs from a
    seed, calibration, plan, compiled session, server with its warm-up,
    a few answers."""
    script = textwrap.dedent("""
        import sys
        import torch
        from portbench import cells, harness, serving
        b = cells.benchmark()
        for w in b["workloads"]:
            cfg = dict(cells.config(w["config"], b), img=32, num_classes=10)
            traffic = dict(cells.traffic(w["traffic"]), max_batch=2, pool=2)
            layers = cells.reference(cfg["reference"]).layers(32, 10, 3)
            inputs = serving.make_inputs(layers, 2, cfg["model_seed"],
                                         2**31 + 7, "cpu")
            sut = serving.Served(cfg, traffic, inputs, "cpu")
            pool = inputs.pool.numpy()
            [f.result(timeout=60) for f in
             [sut.server.submit(pool[i]) for i in range(2)]]
            sut.server.close()
        print("FORBIDDEN", harness.forbidden_modules())
    """)
    res = subprocess.run([sys.executable, "-c", script], env=_env(),
                         capture_output=True, text=True, timeout=240,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "FORBIDDEN []" in res.stdout


def test_run_refuses_without_a_card_and_prints_no_result():
    res = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         _bench()["workloads"][0]["name"], "--seed", str(2**31 + 5),
         "--seconds", "1", "--trace", "0"], env=_env(), capture_output=True,
        text=True, timeout=120, cwd=ROOT)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_run_refuses_in_a_directory_without_the_port(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         _bench()["workloads"][0]["name"], "--seed", "1", "--seconds", "1",
         "--trace", "0"], env=dict(os.environ, PYTHONPATH=""),
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""
