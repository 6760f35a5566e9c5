"""``BENCHMARK.json`` and the files its names lead to."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def man(root):
    return harness.manifest(root)


def test_names_and_units(man):
    names = [c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]]
    names += [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    names += [w["config"] for w in man["workloads"]] + [w["traffic"] for w in man["workloads"]]
    names += [k for c in man["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for m in man["end_to_end"] + man["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    metrics = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(set(metrics)) == len(metrics)


def test_every_cell_finds_its_files(man, root):
    for cell in man["workloads"]:
        conf = harness.entry(man["configs"], cell["config"], "configuration")
        assert (root / conf["file"]).is_file()
        wl = harness.load_json(harness.workload_file(cell["name"]))
        assert harness.driver_file(wl["driver"]).is_file()
        for m in harness.cell_metrics(man, cell["name"], "per_layer"):
            assert hasattr(harness.load_module(harness.metric_file(m["name"]), "m_" + m["name"]),
                           "read")


def test_moves_names_a_metric_each_cell_reports(man):
    for m in man["per_layer"]:
        moved = harness.entry(man["end_to_end"], m["moves"], "metric")
        for cell in m.get("workloads", [w["name"] for w in man["workloads"]]):
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)


def test_every_cell_reports_setup_and_one_more(man):
    for cell in man["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(man, cell["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.cell_metrics(man, cell["name"], "per_layer")


def test_a_new_metric_file_is_picked_up(root, tmp_path):
    """A per-layer metric added as a manifest entry and a reader file is
    found by its name, with no other file edited."""
    shutil.copytree(root / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = harness.manifest(root)
    man["per_layer"].append({"name": "gae_ms", "unit": "ms", "better": "lower",
                             "source": "program_span", "layer": "GAE",
                             "moves": "games_per_s", "workloads": ["mlp7-match-det"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    (tmp_path / "benchmark" / "metrics" / "gae_ms.py").write_text(
        "def read(r):\n    return 1.5\n")
    code = ("import sys; sys.path[:0] = [sys.argv[1]]; sys.path.append(sys.argv[2]); "
            "from benchmark import run; "
            "a = run.parse(['--workload', 'mlp7-match-det', '--seed', '1', '--seconds', '1', "
            "'--trace', '1']); r = run.prepare(a)[-1]; print(sorted(r), r['gae_ms'].read(None))")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path), str(root)],
                         capture_output=True, text=True, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr
    assert "'gae_ms'" in out.stdout and out.stdout.strip().endswith("1.5")


def test_run_refuses_without_a_card(root):
    """Without CUDA the run exits non-zero and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mlp7-match-det",
                          "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(root), env=env, timeout=300)
    assert out.returncode != 0
    assert '"device"' not in out.stdout and "correct" not in out.stdout


def test_run_refuses_without_the_program(root, tmp_path):
    """In a directory holding only the manifest and the benchmark's files the
    run exits non-zero and prints no result line."""
    shutil.copytree(root / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "mlp7-match-det",
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert out.returncode != 0
    assert "correct" not in out.stdout


def test_harness_loads_no_jax(root):
    """The harness, every driver and reader, and each cell's run as prepared
    load neither JAX nor the JAX package."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from benchmark import harness, run; "
            "[run.prepare(run.parse(['--workload', c['name'], '--seed', '1', '--seconds', '1', "
            "'--trace', t])) for c in harness.manifest(run.ROOT)['workloads'] for t in '01']; "
            "[harness.load_module(p, 'x_' + p.stem.replace('.', '_')) "
            "for d in ('drivers', 'metrics') for p in (harness.HERE / d).glob('*.py')]; "
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True, text=True,
                         cwd=str(root))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
