"""A tiny size of every cell, for the CPU tests: the cell's own files with
the scale and the pass cut down, nothing else changed."""

from __future__ import annotations

import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]

SCALE = dict(n_warehouses=3, districts=2, customers=16, n_items=300,
             order_capacity=64, max_lines=15)


def tiny(cfg: dict, traffic: dict) -> tuple[dict, dict]:
    """The cell at a tiny size: stock x1 so the escrow cells sell out and
    abort."""
    cfg = dict(cfg, scale=dict(SCALE), hot_items=6, stock_multiplier=1)
    traffic = dict(traffic, batch=8, batches_per_pass=6, merge_every=2)
    return cfg, traffic


def cell(workload: str):
    from portbench import run

    _, cfg, traffic = run.cell_files(BENCH, workload)
    return tiny(cfg, traffic)


def drive(workload: str, seed: int, seconds: float = 0.02):
    """The driver's record of one run on the CPU at the tiny size."""
    from portbench.drivers import tpcc_fused

    cfg, traffic = cell(workload)
    return tpcc_fused.run(cfg, traffic, seed=seed, seconds=seconds,
                          trace=False, device="cpu", t0=time.perf_counter())
