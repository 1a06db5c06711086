"""Every cell's files are found by name, the benchmark's file keeps to its
contract's shape, and no module under ``portbench/`` imports JAX or the
JAX package (top-level names compared whole), nor the reference the
program."""

import ast
import json
import re
from pathlib import Path

import pytest

from portbench import run
from portbench.tests.tiny import BENCH, CELLS, ROOT, driver

PKG = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_found_by_name(workload):
    cell, cfg, traffic = run.cell_files(BENCH, workload)
    assert (PKG / "drivers" / f"{cfg['driver']}.py").is_file()
    assert (PKG / "reference" / f"{cfg['reference']}.py").is_file()
    assert {"scale", "regime", "n_shards", "guarantees", "source",
            "reduced", "assumed"} <= set(cfg)
    assert set(traffic) - {"about"} <= set(driver(cfg).TRAFFIC)
    for m in run.metrics_of(BENCH, workload, False) + \
            run.metrics_of(BENCH, workload, True):
        mod = run._load(PKG / "metrics" / f"{m['name']}.py", m["name"])
        assert callable(mod.read)


def test_benchmark_file_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["source"] == \
            c["source"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def _imports(path: Path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_jax_and_a_plain_reference():
    files = sorted(PKG.rglob("*.py"))
    assert files
    for f in files:
        bad = _imports(f) & {"jax", "jaxlib", "flax", "repro"}
        assert not bad, (f, bad)
    for f in (PKG / "reference").glob("*.py"):
        assert not _imports(f) & {"repro_torch", "torch"}, f


def test_run_checks_loaded_modules(monkeypatch):
    import sys

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro_torch_extra", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "repro.txn", sys)
    assert run.forbidden_modules() == ["jax.numpy", "repro.txn"]
