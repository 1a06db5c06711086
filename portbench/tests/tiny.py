"""A tiny size of every cell, for the CPU tests: the cell's own files with
the scale and the pass cut down, nothing else changed. Each cell is
reached through its configuration: the driver its ``driver`` key names,
and through that driver's ``replay`` the reference its ``reference`` key
names."""

from __future__ import annotations

import importlib
import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]

SCALE = dict(n_warehouses=3, districts=2, customers=16, n_items=300,
             order_capacity=64, max_lines=15)


def warehouses(n_shards: int) -> int:
    """The tiny warehouse count: the least of at least 3 that the shards
    divide (3 at one shard, 4 at two or four)."""
    w = SCALE["n_warehouses"]
    while w % n_shards:
        w += 1
    return w


def tiny(cfg: dict, traffic: dict) -> tuple[dict, dict]:
    """The cell at a tiny size: stock x1 so the escrow cells sell out and
    abort."""
    scale = dict(SCALE, n_warehouses=warehouses(cfg["n_shards"]))
    cfg = dict(cfg, scale=scale, hot_items=6, stock_multiplier=1)
    traffic = dict(traffic, batch=8, batches_per_pass=6, merge_every=2)
    return cfg, traffic


def cell(workload: str):
    from portbench import run

    _, cfg, traffic = run.cell_files(BENCH, workload)
    return tiny(cfg, traffic)


def driver(cfg: dict):
    """The driver module the configuration names."""
    return importlib.import_module(f"portbench.drivers.{cfg['driver']}")


def drive_cfg(cfg: dict, traffic: dict, seed: int, seconds: float = 0.02):
    """The named driver's record of one run on the CPU."""
    return driver(cfg).run(cfg, traffic, seed=seed, seconds=seconds,
                           trace=False, device="cpu", t0=time.perf_counter())


def drive(workload: str, seed: int, seconds: float = 0.02):
    """The driver's record of one run of the cell on the CPU at the tiny
    size."""
    return drive_cfg(*cell(workload), seed, seconds)
