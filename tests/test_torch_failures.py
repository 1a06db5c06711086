"""Crash recovery of escrow-regime TPC-C against the JAX package's.

The port's ``runtime.failures.EscrowPodSimulator`` and ``txn.recovery``
are held to the reference's on the same seeds:

* the reference's kill / reclaim / drain / recover cycle and its
  bit-identical recovery of a frozen image (``tests/test_failures.py``);
* a run image checkpointed mid-stream through ``run_loop(final_flush=
  False)``, restored through ``restore_run(engine)`` and resumed;
* both bench rows of the reference (``benchmarks/paper_figures.py``'s
  ``escrow_failures`` and ``liveness``) at its toy scale, whose counts are
  the committed ``BENCH_escrow_failures.json`` and ``BENCH_liveness.json``;
* the simulator's one declared difference: the port admits through the
  megastep (``effects="fused"``), the reference through the per-phase scan;
  the two end bit-identical window by window;
* ``straggler_step_times`` float for float.

Tolerance: exact (every quantity is an integer or a bool, and ``s_ytd``
adds integers far below 2**24); the straggler model's floats equal.

``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_failures.py``
prints the JAX package's counts for the two rows at the full-width
deployment of ``chip_smoke.py``'s phase 18 (its ``SIM_REFERENCE``).
"""

import json
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.runtime import failures as jf  # noqa: E402
from repro.txn import recovery as jrec  # noqa: E402
from repro.txn import tpcc as jt  # noqa: E402
from repro.txn.audit import check_cold_ledger as j_check  # noqa: E402
from repro.txn.drivers import run_loop as jrun_loop  # noqa: E402
from repro.txn.engine import single_host_engine as jengine  # noqa: E402
from repro_torch.convert import state_to_numpy  # noqa: E402
from repro_torch.runtime import failures as tf  # noqa: E402
from repro_torch.txn import recovery as trec  # noqa: E402
from repro_torch.txn import tpcc as tt  # noqa: E402
from repro_torch.txn.audit import assert_audit, check_cold_ledger  # noqa: E402
from repro_torch.txn.drivers import run_loop  # noqa: E402
from repro_torch.txn.engine import single_host_engine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the two bench rows' deployments: the reference's toy scale, and
# chip_smoke.py's phase 18 (4 replicas of 16 spec-scale warehouses, 64
# New-Orders a replica a window, one hot item a warehouse, the spec's stock)
TOY = dict(scale=(4, 2, 16, 64, 1024, 15), seed=11, batch=16, windows=12,
           retry_cap=128, retry_max=3, hot_items=None,
           stock_scale={"escrow_failures": 20, "liveness": 3},
           remote_frac=0.5, item_skew=1.2)
FULL = dict(TOY, scale="spec_scale(64)", seed=0, batch=64, retry_cap=256,
            hot_items=1, stock_scale={"escrow_failures": 1, "liveness": 1})
KILLED = 2


def _scale(pkg, cfg):
    if cfg["scale"] == "spec_scale(64)":
        return pkg.TPCCScale.spec_scale(64)
    return pkg.TPCCScale(*cfg["scale"])


def make_sim(package: str, cfg: dict, row: str, **kw):
    """The row's simulator of ``package`` ("jax" or "torch")."""
    if package == "jax":
        Sim, scale, extra = jf.EscrowPodSimulator, _scale(jt, cfg), {}
    else:
        Sim, scale = tf.EscrowPodSimulator, _scale(tt, cfg)
        extra = dict(device="cpu")
    return Sim(scale, 4, retry_cap=cfg["retry_cap"],
               retry_max=cfg["retry_max"], hot_items=cfg["hot_items"],
               seed=cfg["seed"], stock_scale=cfg["stock_scale"][row],
               **extra, **kw)


def _window(sim, cfg):
    sim.step(cfg["batch"], remote_frac=cfg["remote_frac"],
             item_skew=cfg["item_skew"])
    sim.drain()
    sim.refresh()


def escrow_failures_row(package, cfg, kill, directory):
    """``escrow_failures``: steady, or a checkpoint and a kill of replica 2
    at window W/3 and its recovery at 2W/3; then drain to quiescence."""
    sim = make_sim(package, cfg, "escrow_failures")
    W = cfg["windows"]
    for t in range(W):
        if kill and t == W // 3:
            sim.checkpoint(directory, step=t)
            sim.kill(KILLED)
        if kill and t == 2 * W // 3:
            sim.recover(KILLED, directory)
        _window(sim, cfg)
    for _ in range(sim.retry_max + 2):
        sim.drain()
    sim.refresh()
    led = sim.cold_ledger()
    ok = sim.audit().ok
    return sim, {"committed": sim.committed,
                 "final_rejects": led["final_rejects"],
                 "cold_ledger_exact": led["exact"], "audit_ok": ok}


def liveness_row(package, cfg, kill):
    """``liveness``: self-detecting mode with reservations; steady, or
    replica 2 killed at W/3 and revived at 2W/3; then quiesce."""
    sim = make_sim(package, cfg, "liveness", liveness=True, reserve=True)
    W = cfg["windows"]
    detected = None
    for t in range(W):
        if kill and t == W // 3:
            sim.kill(KILLED)
        if kill and t == 2 * W // 3:
            sim.revive(KILLED)
        _window(sim, cfg)
        if kill and detected is None and not sim.alive[KILLED]:
            detected = t - W // 3 + 1
    sim.quiesce()
    sim.refresh()
    led = sim.cold_ledger()
    (j_check if package == "jax" else check_cold_ledger)(led, quiescent=True)
    out = {"committed": sim.committed, "final_rejects": led["final_rejects"],
           "res_granted": led["res_granted"],
           "res_completed": led["res_completed"],
           "cold_ledger_exact": led["exact"],
           "reservations_exact": led["reservations_exact"],
           "audit_ok": sim.audit().ok}
    if kill:
        out["detected_in_windows"] = detected
        out["detection_bound"] = sim.monitor.detection_bound
        out["detection_lags"] = sim.monitor.detection_lags()
        out["handback_ok"] = (sim.owner_of[KILLED] == KILLED
                              and sim.alive[KILLED])
    return sim, out


def _host(tree):
    """A state tree of either package as host numpy arrays."""
    if hasattr(tree, "_fields") and torch.is_tensor(tree[0]):
        return state_to_numpy(tree)
    return type(tree)(*(np.asarray(x) for x in jax.device_get(tree)))


def _diff(a, b) -> list[str]:
    """Fields whose dtype or values differ (bool/int32/float32 on both)."""
    a, b = _host(a), _host(b)
    return [f for f, x, y in zip(a._fields, a, b)
            if x.dtype != y.dtype or not np.array_equal(x, y)]


def _same_sims(js, ts) -> list[str]:
    """Everything the two simulators hold, compared."""
    bad = _diff(js.full_state(), ts.full_state()) + _diff(js.esc, ts.esc)
    for r, (a, b) in enumerate(zip(js.rings, ts.rings)):
        bad += [f"ring{r}.{f}" for f in _diff(a, b)]
    for name in ("pending", "alive", "owner_of", "committed", "cold_sent",
                 "cold_applied", "final_rejects", "res_granted",
                 "res_completed"):
        if getattr(js, name) != getattr(ts, name):
            bad.append(name)
    if js.cold_ledger() != ts.cold_ledger():
        bad.append("cold_ledger")
    return bad


# ---------------------------------------------------------------------------
# the reference's kill / reclaim / drain / recover tests, in both packages
# ---------------------------------------------------------------------------

RECLAIM = dict(scale=(4, 2, 8, 32, 512, 15))


def _both(**kw):
    scale = RECLAIM["scale"]
    return (jf.EscrowPodSimulator(jt.TPCCScale(*scale), **kw),
            tf.EscrowPodSimulator(tt.TPCCScale(*scale), device="cpu", **kw))


def test_escrow_kill_reclaim_drain_recover(tmp_path):
    """Steady state -> checkpoint -> kill -> survivors commit with the dead
    share row reclaimed to zero -> entries for the dead owner queue ->
    recover from the manifest -> drain to quiescence -> audit and an EXACT
    cold ledger; every step equal to the reference's."""
    sims = _both(n_replicas=4, retry_cap=64, retry_max=3, seed=5)
    dirs = (tmp_path / "jax", tmp_path / "torch")

    def windows(n):
        for _ in range(n):
            for s in sims:
                s.step(8, remote_frac=0.5, item_skew=1.5)
                s.drain()
                s.refresh()

    windows(3)
    for s, d in zip(sims, dirs):
        s.checkpoint(str(d), step=3)
        s.kill(2)
    windows(3)
    sim = sims[1]
    assert _same_sims(*sims) == []
    led = sim.cold_ledger()
    assert led["exact"], led
    assert int(sim.esc.shares[2].sum()) == 0
    assert int(sim.esc.shares.sum()) > 0
    assert len(sim.pending[2]) > 0

    for s, d in zip(sims, dirs):
        s.recover(2, str(d))
        for _ in range(s.retry_max + 2):
            s.drain()
        s.refresh()
    assert _same_sims(*sims) == []
    led = sim.cold_ledger()
    assert led["exact"] and led["queued"] == 0 and led["in_ring"] == 0, led
    rep = sim.audit()
    assert rep.ok and rep.checks["twelve_criteria"]
    assert rep.checks["escrow_covers_hot_stock"]


def test_escrow_recover_is_bit_identical_to_frozen_image(tmp_path):
    """Only the owner writes its slice, so the checkpointed image IS the
    dead replica's frozen state: recovery restores it bit-exactly, in the
    port as in the reference."""
    sims = _both(n_replicas=2, retry_cap=32, retry_max=2, seed=9)

    def windows(n):
        for _ in range(n):
            for s in sims:
                s.step(8, remote_frac=0.4, item_skew=1.2)
                s.drain()
                s.refresh()

    windows(2)
    for s in sims:
        s.checkpoint(str(tmp_path / type(s).__module__), step=2)
    frozen = tt.copy_tree(sims[1].slices[1])
    for s in sims:
        s.kill(1)
    windows(2)
    # the killed replica's slice did not move while it was down
    assert _diff(frozen, sims[1].slices[1]) == []
    for s in sims:
        s.recover(1, str(tmp_path / type(s).__module__))
    assert _diff(frozen, sims[1].slices[1]) == []
    assert _diff(sims[0].slices[1], sims[1].slices[1]) == []
    assert _same_sims(*sims) == []


def test_run_image_checkpoint_resume_through_run_loop(tmp_path):
    """Engine-level recovery: a run checkpointed with ``final_flush=False``
    restores bit-exactly through ``restore_run(engine)`` and resumes
    through ``run_loop``; a crash between the shard write and the commit
    leaves ``latest_manifest`` on the committed generation. The resumed
    run ends as the reference's."""
    scale = RECLAIM["scale"]
    kw = dict(batch_per_shard=8, n_batches=8, remote_frac=0.6,
              merge_every=4, refresh_every=1, seed=3, item_skew=1.5)
    ring = dict(retry_cap=64, retry_max=3)

    je = jengine(jt.TPCCScale(*scale), stock_invariant="strict")
    js, jesc, _, jring = jrun_loop(
        je, je.shard_state(jt.init_state(jt.TPCCScale(*scale))),
        fused=False, final_flush=False, return_retry=True, **ring, **kw)
    jman = jrec.save_run(str(tmp_path / "jax"), js, 8, esc=jesc, retry=jring)
    jr = jrec.restore_run(str(tmp_path / "jax"), je)
    js2, jesc2, jst2, jring2 = jrun_loop(
        je, jr.state, jr.esc, fused=False, retry=jr.retry,
        return_retry=True, **ring, **kw)

    te = single_host_engine(tt.TPCCScale(*scale), stock_invariant="strict",
                            device="cpu")
    q0 = tt.init_state(te.scale, device="cpu").s_quantity
    s, e, _, r = run_loop(te, tt.init_state(te.scale, device="cpu"),
                          final_flush=False, return_retry=True, **ring, **kw)
    d = str(tmp_path / "torch")
    man = trec.save_run(d, s, 8, esc=e, retry=r)
    assert man.seq_id == jman.seq_id == 0
    rr = trec.restore_run(d, te)
    assert rr is not None and rr.step == 8
    assert rr.state.s_quantity.device == te.device
    for a, b in ((s, rr.state), (e, rr.esc), (r, rr.retry)):
        assert _diff(a, b) == []
    # a mid-commit crash: shard file + temp manifest written, no commit
    trec.save_run(d, rr.state, 9, esc=rr.esc, retry=rr.retry, commit=False)
    again = trec.restore_run(d, te)
    assert again.step == 8 and again.manifest.seq_id == 0

    s2, e2, st2, r2 = run_loop(te, rr.state, rr.esc, retry=rr.retry,
                               return_retry=True, **ring, **kw)
    assert_audit(s2, escrow=e2, initial_stock=q0, strict_stock=True)
    for a, b in ((js2, s2), (jesc2, e2), (jring2, r2)):
        assert _diff(a, b) == []
    assert (st2.neworders, st2.aborts, st2.cold_rejects) == (
        jst2.neworders, jst2.aborts, jst2.cold_rejects)


def test_restore_run_refuses_incomplete_and_finds_nothing(tmp_path):
    """No manifest: ``None``; a writer set that misses leaves: the
    completeness error, in both packages."""
    assert trec.restore_run(str(tmp_path)) is None
    assert jrec.restore_run(str(tmp_path)) is None
    from repro_torch.ckpt import checkpoint as ck
    te = single_host_engine(tt.TPCCScale(*RECLAIM["scale"]),
                            stock_invariant="strict", device="cpu")
    state = tt.init_state(te.scale, device="cpu")
    ck.save(str(tmp_path), {"state": state}, 1,
            partial={"state/.s_quantity", "state/.c_balance",
                     "state/.ol_qty"})
    with pytest.raises(ValueError, match="incomplete"):
        trec.restore_run(str(tmp_path), te)
    with pytest.raises(ValueError, match="incomplete"):
        trec.restore_run(str(tmp_path))
    with pytest.raises(ValueError, match="incomplete"):
        jrec.restore_run(str(tmp_path))


# ---------------------------------------------------------------------------
# the bench rows at the reference's toy scale
# ---------------------------------------------------------------------------

def _bench(name):
    with open(ROOT / f"BENCH_{name}.json") as f:
        return {r["mode"]: r for r in json.load(f)[name]}


@pytest.mark.parametrize("kill", [False, True])
def test_escrow_failures_row_gives_the_committed_counts(tmp_path, kill):
    """309 steady, 299 through a kill and recover (final rejects 42, 34),
    exact ledgers, clean audits."""
    _, got = escrow_failures_row("torch", TOY, kill, str(tmp_path))
    want = _bench("escrow_failures")["kill_recover" if kill else "steady"]
    assert got == {k: want[k] for k in got}
    assert got["committed"] == (299 if kill else 309)


@pytest.mark.parametrize("kill", [False, True])
def test_liveness_row_gives_the_committed_counts(kill):
    """95 steady, 91 degraded; the kill detected in 3 windows of a bound of
    3, the shard handed back, both ledgers exact."""
    _, got = liveness_row("torch", TOY, kill)
    want = _bench("liveness")["degraded" if kill else "steady"]
    assert got == {k: want[k] for k in got}
    assert got["committed"] == (91 if kill else 95)


# ---------------------------------------------------------------------------
# the declared difference: megastep admission against the reference's scan
# ---------------------------------------------------------------------------

def test_megastep_admission_is_bit_identical_to_the_reference_scan():
    """The port's ``step`` admits through ``effects="fused"`` (the megastep
    on the card), the reference's through the per-phase scan: window by
    window, in self-detecting mode with reservations, through a kill, its
    detection, the successor's adoption and a revival, the two simulators
    hold the same state, escrow, rings, queues and ledger (the
    checkpoint-and-recover schedule is compared the same way above)."""
    sims = _both(n_replicas=4, retry_cap=64, retry_max=3, seed=5,
                 stock_scale=2, liveness=True, reserve=True)
    for t in range(7):
        for s in sims:
            if t == 1:
                s.kill(1)
            if t == 5:
                s.revive(1)
            s.step(8, remote_frac=0.5, item_skew=1.5)
            s.drain()
            s.refresh()
        assert _same_sims(*sims) == [], t
    assert sims[1].monitor.detections and sims[1].monitor.revivals


def test_simulator_step_goes_through_the_megastep(monkeypatch):
    """Every serving replica's step reaches the megastep wrapper
    (``ops.txn_megastep``: the kernel on the card, its plain version here),
    never the scan and its effect products."""
    calls = []
    real = tt.ops.txn_megastep

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    def scan(*a, **k):
        raise AssertionError("the simulator's step took the scan")

    monkeypatch.setattr(tt.ops, "txn_megastep", counted)
    monkeypatch.setattr(tt, "megastep_effect_products", scan)
    sim = make_sim("torch", TOY, "escrow_failures")
    sim.kill(3)
    _window(sim, TOY)
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# the straggler model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(n_pods=8, merge_every=16, steps=128, slowdown=3.0),
    dict(n_pods=8, merge_every=1, steps=128, slowdown=3.0),
    dict(n_pods=8, merge_every=16, steps=128, straggler_pod=3,
         mode="permanent"),
    dict(n_pods=3, merge_every=5, steps=37, seed=7, hiccup_prob=0.3,
         base_ms=20.0),
])
def test_straggler_step_times_float_for_float(kw):
    assert tf.straggler_step_times(**kw) == jf.straggler_step_times(**kw)


if __name__ == "__main__":
    # the JAX package's counts for chip_smoke.py's phase 18 (c)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for kill in (False, True):
            _, out[f"escrow_failures/{'kill' if kill else 'steady'}"] = \
                escrow_failures_row("jax", FULL, kill, os.path.join(
                    d, str(kill)))
    for kill in (False, True):
        _, out[f"liveness/{'kill' if kill else 'steady'}"] = liveness_row(
            "jax", FULL, kill)
    print(json.dumps(out, indent=1))
