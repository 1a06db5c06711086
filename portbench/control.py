"""The control of a cell, at the cell's own size: the reference computed
in bfloat16 put in the program's place, judged against the float32
reference over the pass a run with that seed judges, one JSON line a
seed with each number compared and the reference's host seconds. It has
to come out as not correct. The initial tables are built as a run builds
them, on the card where there is one.

    python3 portbench/control.py --workload merge.neworder --seeds 1 2 3
"""

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from portbench import run  # noqa: E402
from portbench.reference import judge  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    _, cfg, traffic = run.cell_files(
        json.loads((run.ROOT / "BENCHMARK.json").read_text()), args.workload)
    driver = importlib.import_module(f"portbench.drivers.{cfg['driver']}")
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    escrow = cfg["regime"] == "escrow"
    for seed in args.seeds:
        judged, initial = driver.initial_tables(cfg, traffic, seed, device)
        out = {"workload": args.workload, "seed": seed}
        res = {}
        for precision in ("float32", "bfloat16"):
            t = time.perf_counter()
            res[precision] = driver.replay(cfg, traffic, initial, judged,
                                           precision)
            out[f"reference_s_{precision}"] = time.perf_counter() - t
        low = res["bfloat16"]
        numbers = judge.judge(res["float32"], dict(
            tables=low.tables, tail=0, counters=[low.counters],
            shares=low.shares, spent=low.spent), escrow)
        out.update(numbers=numbers, correct=judge.verdict(numbers),
                   counters=res["float32"].counters)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
