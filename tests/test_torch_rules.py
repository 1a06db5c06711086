"""The port's structural rules.

* No file of ``src/repro_torch/`` and not ``chip_smoke.py`` imports JAX or
  anything of the JAX package ``repro``.
* Importing ``repro_torch`` leaves ``jax`` out of ``sys.modules``.
* Entry points (the engine, the state and stream builders, the pod
  simulators, serving and training) run on the CUDA card unless the
  caller passes ``device="cpu"``: with no card they raise instead of
  falling back.
* The kernel modules hold no ``try`` (no path that falls back from a
  kernel to its plain version).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.txn import tpcc  # noqa: E402
from repro_torch.txn.drivers import run_loop  # noqa: E402
from repro_torch.txn.engine import single_host_engine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) > 10
    # the observability plane, the serving driver and training are among
    # them
    assert {PORT / "obs" / f for f in ("__init__.py", "metrics.py",
                                      "ledger.py", "trace.py")} | {
        PORT / "launch" / "tpcc_serve.py"} | {
        PORT / d / f for d, f in (
            ("optim", "adamw.py"), ("optim", "coord.py"),
            ("optim", "compression.py"), ("data", "pipeline.py"),
            ("runtime", "train.py"), ("launch", "train.py"))} <= set(files)
    offenders = {str(p.relative_to(ROOT)): sorted(
        _imported_roots(p) & {"jax", "jaxlib", "repro"}) for p in files}
    assert {k: v for k, v in offenders.items() if v} == {}


def test_importing_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.txn, repro_torch.kernels,"
            " repro_torch.models, repro_torch.configs,"
            " repro_torch.runtime.serve, repro_torch.launch.serve,"
            " repro_torch.runtime, repro_torch.ckpt, repro_torch.txn.recovery,"
            " repro_torch.obs, repro_torch.obs.ledger,"
            " repro_torch.launch.tpcc_serve, repro_torch.optim,"
            " repro_torch.data, repro_torch.runtime.train,"
            " repro_torch.launch.train;"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))];"
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   timeout=120)


def test_kernel_modules_have_no_fallback():
    for name in ("ops.py", "escrow_admit.py", "txn_megastep.py",
                 "ramp_read.py", "lattice_merge.py", "flash_attention.py",
                 "rwkv6_scan.py"):
        tree = ast.parse((PORT / "kernels" / name).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), name


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scale = tpcc.TPCCScale()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        single_host_engine(scale)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpcc.init_state(scale)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpcc.generate_neworder(np.random.default_rng(0), scale, 4)
    from repro_torch.runtime.failures import EscrowPodSimulator
    with pytest.raises(RuntimeError, match="no CUDA device"):
        EscrowPodSimulator(scale, 2)
    from repro_torch.launch import tpcc_serve
    for argv in ([], ["--chaos"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpcc_serve.main(argv)
    from repro_torch.obs import metrics as obsm
    with pytest.raises(RuntimeError, match="no CUDA device"):
        obsm.make_obs_metrics(1, 4)
    # asked for explicitly, the CPU is fine
    eng = single_host_engine(scale, device="cpu")
    assert eng.device == torch.device("cpu")


def test_serving_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.launch import serve as launch
    from repro_torch.runtime.serve import ServeConfig, Server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_config("smollm-360m").reduced()
    for arch in ("smollm-360m", "rwkv6-3b"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            registry.init_params(registry.get_config(arch).reduced())
    model = registry.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(cfg, model, ServeConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run(["--arch", "smollm-360m", "--reduced"])
    # asked for explicitly, the CPU is fine
    assert Server(cfg, model, ServeConfig(), device="cpu").device == \
        torch.device("cpu")


def test_training_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.launch import train as launch
    from repro_torch.optim import adamw, coord
    from repro_torch.runtime import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = registry.get_config("smollm-360m").reduced()
    tc = train.TrainConfig(steps=1, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run(cfg, tc)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        coord.build(cfg, coord.CoordConfig(), adamw.AdamWConfig(),
                    registry.make_loss_fn)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run(["--arch", "smollm-360m", "--reduced", "--steps", "1"])
    # asked for explicitly, the CPU is fine
    _, summary = train.run(cfg, tc, device="cpu")
    assert summary["step"] == 1
    assert coord.build(cfg, coord.CoordConfig(), adamw.AdamWConfig(),
                       registry.make_loss_fn, device="cpu").device == \
        torch.device("cpu")


def test_unported_paths_raise_not_implemented():
    scale = tpcc.TPCCScale()
    # multi-shard state is ported: two shards build and run a batch
    two_shards = single_host_engine(scale, stock_invariant="strict",
                                    admission="scan", device="cpu",
                                    n_shards=2)
    assert two_shards.w_per_shard == scale.n_warehouses // 2
    _, _, st2 = run_loop(two_shards, tpcc.init_state(scale, device="cpu"),
                         batch_per_shard=2, n_batches=1)
    assert st2.neworders + st2.aborts == 4
    # the dense escrow layout is ported: it builds
    dense = single_host_engine(scale, stock_invariant="strict",
                               escrow_layout="dense", device="cpu")
    assert dense.escrow_layout == "dense"
    # a COORDINATION_REQUIRED plan is refused as the reference refuses it,
    # pointing to the 2PC fallback; that runs on two shards too
    with pytest.raises(ValueError, match="plan_engine"):
        single_host_engine(scale, stock_invariant="serial", device="cpu")
    from repro_torch.txn.twopc import TwoPCEngine, run_closed_loop_2pc
    _, st2 = run_closed_loop_2pc(
        TwoPCEngine(scale, strict_stock=True, device="cpu", n_shards=2),
        tpcc.init_state(scale, device="cpu"), batch_per_shard=2,
        n_batches=1)
    assert st2.committed + st2.aborted == 4
    eng = single_host_engine(scale, device="cpu")
    # the fused executor is ported and is the default: it runs, ending
    # where the dispatch path ends
    runs = [run_loop(eng, tpcc.init_state(scale, device="cpu"),
                     batch_per_shard=2, n_batches=3, merge_every=2, **kw)
            for kw in ({}, dict(fused=True), dict(fused=False))]
    for s, _, st in runs[1:]:
        assert all(torch.equal(x, y) for x, y in zip(s, runs[0][0]))
        assert (st.neworders, st.anti_entropy_rounds) == (
            runs[0][2].neworders, runs[0][2].anti_entropy_rounds) == (6, 2)
    # the observability plane is ported: the session's snapshot holds the
    # run's metrics and ledger
    from repro_torch.obs import ObsSession
    obs = ObsSession(metrics=True, ledger=True)
    run_loop(eng, tpcc.init_state(scale, device="cpu"), batch_per_shard=2,
             n_batches=2, merge_every=2, obs=obs)
    snap = obs.snapshot()
    assert snap["latency"]["neworder"]["count"] == 4
    assert snap["ledger"]["hot_collectives"] == 0
    # liveness is ported: a lease monitor ticks once a drain window
    from repro_torch.runtime.liveness import LeaseMonitor
    mon = LeaseMonitor(2, source=lambda w: np.full(2, w + 1, np.int64))
    run_loop(two_shards, tpcc.init_state(scale, device="cpu"),
             batch_per_shard=2, n_batches=2, merge_every=1, liveness=mon)
    assert mon.window == 2 and mon.detections == []
    # the cold-retry ring is ported; the merge regime refuses it as the
    # reference does
    with pytest.raises(ValueError, match="requires the escrow regime"):
        run_loop(eng, tpcc.init_state(scale, device="cpu"),
                 batch_per_shard=2, n_batches=1, retry_cap=4)
