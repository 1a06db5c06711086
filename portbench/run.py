"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 portbench/run.py --workload merge.neworder --seed 7 \\
        --seconds 10 --trace 0

Everything is found by name: the cell in ``BENCHMARK.json``'s
``workloads``; its configuration's file (``configs[].file``), whose
``driver`` key names ``portbench/drivers/<driver>.py``; its traffic mix in
``portbench/traffic/<traffic>.json``; each metric's reader in
``portbench/metrics/<metric>.py``. With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.

The last line of standard output is the result as one JSON object; the
numbers the correctness check compared, each beside its limit, are the
last lines of standard error and the last key of that object. The run
exits with a code other than 0, and prints no result, without a CUDA
device (or with fewer than the cell asks for), or when the JAX package
or JAX itself was loaded into this process.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BENCH = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _load(path: Path, name: str):
    """A module from a file of ``portbench/`` found by name."""
    if not path.is_file():
        raise SystemExit(f"portbench: no file {path.relative_to(ROOT)} for "
                         f"{name!r}")
    spec = importlib.util.spec_from_file_location(
        f"portbench._by_name.{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration file, traffic file) of a workload by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, traffic


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones (those that list it, or list no
    cells)."""
    kind = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in kind if workload in m.get("workloads", [workload])]


def read_metrics(bench: dict, workload: str, trace: bool, rec) -> dict:
    out = {}
    for m in metrics_of(bench, workload, trace):
        reader = _load(BENCH / "metrics" / f"{m['name']}.py", m["name"])
        value = reader.read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _card(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count}


def main(argv=None, *, device: str | None = None, overrides=None) -> int:
    """One run. ``device`` and ``overrides`` (a function of the
    configuration and traffic dicts that returns new ones) are for the
    CPU tests, which drive the rest of a run at a tiny size."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for sub in ("src", ""):
        path = str(ROOT / sub) if sub else str(ROOT)
        if path not in sys.path:
            sys.path.insert(0, path)
    os.environ.setdefault("USE_FLAX", "0")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cfg, traffic = cell_files(bench, args.workload)
    if overrides is not None:
        cfg, traffic = overrides(cfg, traffic)

    import torch

    # the window's host work is one thread's; no CPU pool to contend
    torch.set_num_threads(1)
    if device is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if found < cell["chips"]:
            print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
                  f"device(s); found {found}", file=sys.stderr)
            return 2
        device = "cuda"
    driver = _load(BENCH / "drivers" / f"{cfg['driver']}.py", cfg["driver"])
    rec = driver.run(cfg, traffic, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device=device, t0=T0)
    metrics = read_metrics(bench, args.workload, bool(args.trace), rec)

    bad = forbidden_modules()
    if bad:
        print(f"portbench: the process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    dev = (_card(cell["chips"]) if device == "cuda" else
           {"platform": "cpu", "kind": "cpu", "count": 1})
    dev["memory_peak_bytes"] = int(rec.memory_peak_bytes)
    result = {"correct": bool(rec.correct), "attempted": int(rec.attempted),
              "failed": int(rec.failed), "metrics": metrics, "device": dev}
    if args.trace and rec.trace is not None:
        from portbench import tracing

        dev["busy_s"] = rec.trace.busy_s
        dev["window_s"] = rec.trace.window_s
        result["breakdown"] = {"device_ops": tracing.top_ops(rec.trace),
                               "idle_gaps": rec.trace.idle_gaps}
    result["run"] = getattr(rec, "diag", {})
    result["checks"] = {k: {"value": v, "limit": rec.limits[k]}
                        for k, v in rec.checks.items()}
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    for k, v in rec.checks.items():
        print(f"check {k} {v} limit {rec.limits[k]}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
