"""The training loop of the port (``repro_torch.optim.coord.build``,
``runtime.train.run`` with a checkpoint and a restart,
``runtime.failures.PodSimulator`` and ``python -m
repro_torch.launch.train``) against the JAX package, on the CPU, at
reduced smollm-360m (float32, 2 layers, d 64).

The reference runs on a mesh with Auto axes and ``Rules.disabled()`` (its
own training tests fail on this JAX: ``jax.make_mesh`` makes explicit
axes and the embedding gather raises ``ShardingTypeError``). Its runs go to
two subprocesses started with the module's first test, ``python
tests/test_torch_train_loop.py OUT PODS KIND`` (``JOBS``), on one device
or with the ``pod`` axis over 2 simulated devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=2``), while the
port's side runs here. Both packages
start from the reference's initial parameters (the port's
``registry.init_params`` is patched to return them) and step on the same
numpy batches or the same pipeline.

Tolerances: the state 1e-5 (float32, the two differ in the order of float
sums); the compressed merges one quantum of the leaf besides: bf16 a
bf16 ulp of its largest value, int8 that value over 127 (a value a
rounding boundary apart in the two packages lands one quantum apart);
metrics 1e-5 relative, steps and tokens exactly. The int8 runs diverge
past their first merge (the merged second moments amplify a quantum), so
``train.run`` at int8 is held to the reference's history within 1% up to
the blow-up and to its large final loss.
"""

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models.sharding import Rules  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import coord as jcoord  # noqa: E402
from repro.runtime import failures as jfailures  # noqa: E402
from repro.runtime import train as jtrain  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.optim import adamw, coord  # noqa: E402
from repro_torch.runtime import failures, train  # noqa: E402
from repro_torch.txn import collectives  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"
ARCH = "smollm-360m"
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=50)
B, S = 4, 16
# (mode, compress, microbatch, pods, steps): the merge every 2 steps; the
# int8 runs stop at their first merge
COORD = [("sync", "none", 1, 1, 4), ("sync", "none", 2, 1, 4),
         ("sync", "none", 1, 2, 4), ("hierarchical", "none", 1, 2, 4),
         ("hierarchical", "bf16", 1, 2, 4), ("hierarchical", "int8", 1, 2, 2),
         ("local_sgd", "none", 1, 2, 4), ("local_sgd", "bf16", 1, 2, 4),
         ("local_sgd", "int8", 1, 2, 2)]
# (mode, compress, pods, lr): a run of 6 steps with a checkpoint at 3, a
# restart to 8; the int8 case at lr 1e-3 blows up, as the reference's does
RUNS = [("sync", "none", 1, 3e-4), ("hierarchical", "none", 2, 3e-4),
        ("hierarchical", "int8", 2, 1e-3)]


def _key(case) -> str:
    return "-".join(str(x) for x in case)


def _batches(n, batch=B, seed=3):
    cfg = registry.get_config(ARCH).reduced()
    rng = np.random.default_rng(seed)
    return [{k: rng.integers(0, cfg.vocab, (batch, S)).astype(np.int32)
             for k in ("tokens", "labels")} for _ in range(n)]


def _mesh(pods):
    return jax.make_mesh((pods, 1, 1), ("pod", "data", "model"),
                         axis_types=(AxisType.Auto,) * 3)


def _jcfg():
    return jregistry.get_config(ARCH).reduced()


# ---------------------------------------------------------------------------
# the reference's runs
# ---------------------------------------------------------------------------


def ref_coord(mode, compress, micro, pods, steps):
    """The reference's ``coord.build`` state after ``steps`` steps (a merge
    every 2): (leaves as numpy, ``read_metrics``)."""
    cc = jcoord.CoordConfig(mode=mode, merge_every=2, compress=compress,
                            microbatch=micro)
    batches = _batches(steps)
    specs = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
             for k, v in batches[0].items()}
    setup = jcoord.build(_jcfg(), Rules.disabled(), _mesh(pods), cc,
                         jadamw.AdamWConfig(**OPT),
                         lambda c, r: jregistry.make_loss_fn(c, r,
                                                             remat=False),
                         specs)
    state = setup.init_fn(jax.random.PRNGKey(0))
    for t, b in enumerate(batches):
        state = setup.step_fn(state, jax.tree.map(jnp.asarray, b))
        if setup.merge_fn is not None and (t + 1) % 2 == 0:
            state = setup.merge_fn(state)
    return ([np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(state))], setup.read_metrics(state))


def _summary(m):
    return {k: v for k, v in m.items() if k != "wall_seconds"}


def ref_run(mode, compress, pods, lr):
    """The reference's ``train.run``: 6 steps logged every step with a
    checkpoint at 3, then a restart to 8. Returns (the restarted state's
    leaves, both summaries)."""
    def tc(steps, ckpt_every, d):
        return jtrain.TrainConfig(
            steps=steps, log_every=1, ckpt_every=ckpt_every, ckpt_dir=d,
            seq_len=S, global_batch=B, remat=False,
            coord=jcoord.CoordConfig(mode=mode, merge_every=2,
                                     compress=compress),
            opt=jadamw.AdamWConfig(lr=lr, warmup_steps=2, total_steps=50))
    with tempfile.TemporaryDirectory() as d:
        _, first = jtrain.run(_jcfg(), _mesh(pods), Rules.disabled(),
                              tc(6, 3, d))
        state, second = jtrain.run(_jcfg(), _mesh(pods), Rules.disabled(),
                                   tc(8, 0, d), restore_from=d)
    return ([np.asarray(x) for x in jax.tree_util.tree_leaves(
        jax.device_get(state))], [_summary(first), _summary(second)])


def _pod_sim_batches():
    """The reference test's batches: at time t, pod i's is
    ``make_train_batch(PRNGKey(t + i), cfg, 2, 16)``, as numpy."""
    return [[jax.device_get(jregistry.make_train_batch(
        jax.random.PRNGKey(t + i), _jcfg(), 2, 16)) for i in range(3)]
        for t in range(6)]


def pod_sim_sequence(sim, batches) -> list:
    """``tests/test_failures.py::test_pod_failure_and_recovery``'s sequence
    on a 3-pod simulator (2 steps, merge, kill pod 1, 3 steps, recover it
    from a survivor, a step, merge); the readings (``fleet_metrics``,
    ``divergence``, ``check_validity``) after the first steps, each merge
    and each later step."""
    readings = []

    def read():
        readings.append((sim.fleet_metrics(), sim.divergence(),
                         sim.check_validity()))

    for t in range(2):
        sim.step(batches[t])
    read()
    sim.merge()
    read()
    sim.kill(1)
    for t in range(2, 5):
        sim.step(batches[t])
        read()
    sim.recover(1)
    sim.step(batches[5])
    read()
    sim.merge()
    read()
    return readings


def ref_pod_sim():
    """The reference's simulator on its sync setup of one pod, every pod
    from ``init_fn(PRNGKey(7))`` (its default)."""
    batches = _pod_sim_batches()
    setup = jcoord.build(
        _jcfg(), Rules.disabled(), _mesh(1), jcoord.CoordConfig(mode="sync"),
        jadamw.AdamWConfig(warmup_steps=1, total_steps=50),
        lambda c, r: jregistry.make_loss_fn(c, r, remat=False),
        {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
         for k, v in batches[0][0].items()})
    init = jax.device_get(setup.init_fn(jax.random.PRNGKey(7)))
    sim = jfailures.PodSimulator(setup, 3, states=[
        jax.tree.map(jnp.asarray, init) for _ in range(3)])
    readings = pod_sim_sequence(sim, [jax.tree.map(jnp.asarray, b)
                                      for b in batches])
    return readings, int(sim.states[0].step)


JOBS = [(1, "coord"), (1, "run"), (2, "coord"), (2, "run")]


def reference_runs(path: str, pods: int, kind: str) -> None:
    """The ``kind`` cases (``coord``: ``COORD``, and on one pod the
    simulator's sequence; ``run``: ``RUNS``) of ``pods`` pods, into
    ``path`` (.npz) and their metrics as the last line of stdout."""
    arrays, metrics = {}, {}
    if kind == "coord":
        cases = [(c, ref_coord) for c in COORD if c[3] == pods]
    else:
        cases = [(r, ref_run) for r in RUNS if r[2] == pods]
    for case, fn in cases:
        leaves, metrics[_key(case)] = fn(*case)
        arrays.update({f"{_key(case)}/{i}": x for i, x in enumerate(leaves)})
    if (pods, kind) == (1, "coord"):
        metrics["pod_sim"] = ref_pod_sim()
    np.savez(path, **arrays)
    print(json.dumps(metrics))


@pytest.fixture(scope="module", autouse=True)
def _reference_processes(tmp_path_factory):
    """Start the reference's runs with the module's first test, a
    subprocess a job of ``JOBS`` (its pods on simulated devices), while
    the port's side runs; :func:`ref` waits for them."""
    d = tmp_path_factory.mktemp("train")
    procs = {}
    for pods, kind in JOBS:
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   PYTHONPATH=str(ROOT / "src"),
                   XLA_FLAGS=f"--xla_force_host_platform_device_count={pods}")
        name = f"ref{pods}{kind}"
        log = open(d / f"{name}.log", "w")
        procs[name] = (subprocess.Popen(
            [sys.executable, __file__, str(d / f"{name}.npz"), str(pods),
             kind], env=env, stdout=log, stderr=subprocess.STDOUT,
            text=True), log)
    yield d, procs
    for proc, log in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


@pytest.fixture(scope="module")
def ref(_reference_processes):
    """(arrays by key, metrics by case key) of every reference run."""
    d, procs = _reference_processes
    arrays, metrics = {}, {}
    for name, (proc, _) in procs.items():
        rc = proc.wait(timeout=600)
        text = (d / f"{name}.log").read_text()
        assert rc == 0, text[-3000:]
        with np.load(d / f"{name}.npz") as data:
            arrays.update(data)
        metrics.update(json.loads(text.strip().splitlines()[-1]))
    return arrays, metrics


# ---------------------------------------------------------------------------
# the port's runs
# ---------------------------------------------------------------------------


@pytest.fixture
def ref_init(monkeypatch):
    """The port's ``registry.init_params`` patched to build the
    reference's initial parameters (``PRNGKey(seed)``) on the device it is
    asked for (shapes alone on the meta device, as before)."""
    jcfg = _jcfg()
    init = jax.jit(lambda k: jregistry.init_params(k, jcfg))
    original = registry.init_params

    def init_params(cfg, seed=0, device=None):
        if str(device) == "meta":
            return original(cfg, seed, device)
        tree = jax.device_get(init(jax.random.PRNGKey(seed)))
        return convert.params_from_numpy(tree, cfg, device)

    monkeypatch.setattr(registry, "init_params", init_params)
    return init_params


def port_coord(mode, compress, micro, pods, steps):
    cfg = registry.get_config(ARCH).reduced()
    setup = coord.build(cfg, coord.CoordConfig(mode=mode, merge_every=2,
                                               compress=compress,
                                               microbatch=micro),
                        adamw.AdamWConfig(**OPT),
                        lambda c: registry.make_loss_fn(c, remat=False),
                        n_pods=pods, device=CPU)
    state = setup.init_fn(0)
    for t, b in enumerate(_batches(steps)):
        state = setup.step_fn(state, {k: torch.from_numpy(v)
                                      for k, v in b.items()})
        if setup.merge_fn is not None and (t + 1) % 2 == 0:
            state = setup.merge_fn(state)
    return state, setup.read_metrics(state)


def port_run(mode, compress, pods, lr, directory):
    def tc(steps, ckpt_every):
        return train.TrainConfig(
            steps=steps, log_every=1, ckpt_every=ckpt_every,
            ckpt_dir=directory, seq_len=S, global_batch=B, remat=False,
            coord=coord.CoordConfig(mode=mode, merge_every=2,
                                    compress=compress),
            opt=adamw.AdamWConfig(lr=lr, warmup_steps=2, total_steps=50))
    cfg = registry.get_config(ARCH).reduced()
    _, first = train.run(cfg, tc(6, 3), n_pods=pods, device=CPU)
    state, second = train.run(cfg, tc(8, 0), n_pods=pods, device=CPU,
                              restore_from=directory)
    return state, [_summary(first), _summary(second)]


def _quantum(compress, want):
    """One merge quantum of a leaf (see the module's docstring)."""
    top = float(np.abs(want).max()) if want.size else 0.0
    return {"bf16": top * 2.0 ** -8, "int8": top / 127.0}.get(compress, 0.0)


def _same_state(got, want, compress="none"):
    leaves = T.leaves(got)
    assert len(leaves) == len(want)
    for i, (a, b) in enumerate(zip(leaves, want)):
        a = a.numpy()
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(
                a, b, rtol=1e-5, atol=1e-5 + _quantum(compress, b),
                err_msg=f"leaf {i}")


def _same_metrics(got, want):
    assert got["step"] == want["step"] and got["tokens"] == want["tokens"]
    for k in ("loss_mean", "grad_norm_last"):
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


@pytest.mark.parametrize("argv", [
    [], ["--coord", "hierarchical", "--pods", "2", "--merge-every", "2",
         "--compress", "int8"]])
def test_launcher_on_the_cpu(argv, tmp_path, capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu``: the
    plan, the log lines, a checkpoint, and ``--plan-only``."""
    out = launch.run(["--arch", ARCH, "--reduced", "--device", "cpu",
                      "--steps", "4", "--batch", "4", "--seq", "16",
                      "--log-every", "2", "--ckpt-every", "2",
                      "--ckpt-dir", str(tmp_path)] + argv)
    text = capsys.readouterr().out
    assert "coordination plan" in text and "done: 4 steps" in text
    assert out["summary"]["tokens"] == 4 * 4 * 16
    assert (tmp_path / "SEQUENCE").read_text() == "1"
    assert launch.run(["--arch", ARCH, "--plan-only", "--device", "cpu",
                       "--coord", "local_sgd"])["plan"].entry(
        "grads").spec.merge_every == 8


def test_hot_path_calls_no_collective():
    """The deferred step crosses no pod; only the merge does, through
    ``txn.collectives``: int8 a pmax and an all-gather a leaf and tree
    (params, mu, nu)."""
    cfg = registry.get_config(ARCH).reduced()
    setup = coord.build(cfg, coord.CoordConfig(mode="hierarchical",
                                               compress="int8"),
                        adamw.AdamWConfig(), registry.make_loss_fn,
                        n_pods=2, device=CPU)
    state = setup.init_fn(0)
    batch = {k: torch.from_numpy(v) for k, v in _batches(1)[0].items()}
    with collectives.counted() as hot:
        state = setup.step_fn(state, batch)
    assert hot.total_ops == 0
    with collectives.counted() as merge:
        setup.merge_fn(state)
    n = len(T.leaves(state.params))
    assert dict(merge.counts) == {"all-gather": 3 * n, "all-reduce": 3 * n}
    assert merge.bytes["all-gather"] == 3 * sum(
        x.numel() for x in T.leaves(state.params))


def test_restart_resumes_bit_for_bit(tmp_path):
    """A run checkpointed at step 3 and restarted to 6 ends in the same
    bits as an uninterrupted 6-step run (the pipeline's cursors restored
    with the state)."""
    cfg = registry.get_config(ARCH).reduced()

    def tc(steps, ckpt_every, d):
        return train.TrainConfig(steps=steps, log_every=3,
                                 ckpt_every=ckpt_every, ckpt_dir=d,
                                 seq_len=S, global_batch=B,
                                 coord=coord.CoordConfig(
                                     mode="hierarchical", merge_every=2,
                                     compress="bf16"))
    whole, _ = train.run(cfg, tc(6, 0, str(tmp_path / "a")), n_pods=2,
                         device=CPU)
    train.run(cfg, tc(3, 3, str(tmp_path / "b")), n_pods=2, device=CPU)
    resumed, summary = train.run(cfg, tc(6, 0, str(tmp_path / "b")),
                                 n_pods=2, device=CPU,
                                 restore_from=str(tmp_path / "b"))
    assert summary["step"] == 6
    for a, b in zip(T.leaves(resumed), T.leaves(whole)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", COORD, ids=_key)
def test_coord_build_matches_reference(ref_init, ref, case):
    """One pod: sync with microbatch 1 and 2. Two pods: sync, and the
    deferred modes with each compression, params and moments with the pod
    dim, each pod on its block of the batch, the merge every 2 steps. The
    whole ``TrainState`` and the G-counter reads."""
    arrays, metrics = ref
    state, got = port_coord(*case)
    want = [arrays[f"{_key(case)}/{i}"] for i in range(len(T.leaves(state)))]
    _same_state(state, want, case[1])
    _same_metrics(got, metrics[_key(case)])
    if case[0] != "sync":
        lead = state.params["layers"]["attn"]["wq"]
        assert lead.shape[0] == 2 and torch.equal(lead[0], lead[1])


@pytest.mark.parametrize("case", RUNS, ids=_key)
def test_train_run_matches_reference(ref_init, ref, case, tmp_path):
    """6 steps logged every step, checkpoints at 3 and 6, then a restart to
    8 from the newest: sync on one pod and hierarchical on two. Unless
    int8, the final state, ``step``, ``tokens``, ``loss_mean``,
    ``grad_norm_last`` and every log line; at int8 the history within 1%
    until the merged moments blow the loss up, then a loss as large as
    the reference's."""
    arrays, metrics = ref
    state, summaries = port_run(*case, str(tmp_path))
    jsummaries = metrics[_key(case)]
    assert (tmp_path / "SEQUENCE").read_text() == "1"
    assert [h["step"] for h in summaries[1]["history"]] == [7, 8]
    if case[1] == "none":
        _same_state(state, [arrays[f"{_key(case)}/{i}"]
                            for i in range(len(T.leaves(state)))])
        for got, want in zip(summaries, jsummaries):
            _same_metrics(got, want)
            assert len(got["history"]) == len(want["history"])
            for a, b in zip(got["history"], want["history"]):
                _same_metrics(a, b)
        return
    got = [h["loss_mean"] for h in summaries[0]["history"]]
    want = [h["loss_mean"] for h in jsummaries[0]["history"]]
    assert got[:3] == pytest.approx(want[:3], rel=1e-5)   # before the merge
    assert got[3:5] == pytest.approx(want[3:5], rel=1e-2)
    assert want[5] > 20 * want[0] and got[5] > 20 * want[0]


def test_pod_simulator_matches_reference(ref_init, ref):
    """The sequence of ``tests/test_failures.py::
    test_pod_failure_and_recovery`` (:func:`pod_sim_sequence`) on the
    port's simulator, built with ``states=`` from the reference's initial
    state, against the reference's: ``fleet_metrics``, ``divergence`` and
    ``check_validity`` at each reading (1e-5; divergence 1e-4 relative)."""
    cfg = registry.get_config(ARCH).reduced()
    setup = coord.build(cfg, coord.CoordConfig(mode="sync"),
                        adamw.AdamWConfig(warmup_steps=1, total_steps=50),
                        lambda c: registry.make_loss_fn(c, remat=False),
                        device=CPU)
    init = setup.init_fn(7)
    sim = failures.PodSimulator(setup, 3, states=[
        T.map(torch.clone, init) for _ in range(3)])
    batches = [[{k: torch.tensor(np.asarray(v)) for k, v in b.items()}
                for b in pods] for pods in _pod_sim_batches()]
    readings = pod_sim_sequence(sim, batches)
    want, step = ref[1]["pod_sim"]
    assert int(sim.states[0].step) == step == 6
    assert len(readings) == len(want)
    for got, exp in zip(readings, want):
        assert got[2] is exp[2] is True
        assert got[1] == pytest.approx(exp[1], rel=1e-4, abs=1e-6)
        for k in ("loss_sum", "tokens", "grad_norm_max"):
            assert got[0][k] == pytest.approx(exp[0][k], rel=1e-5), k
    assert readings[-1][1] < 1e-5 < readings[-2][1]
    # each token counted once: pods 0 and 2 took 6 steps of 32 tokens,
    # pod 1 2 before the kill and 1 after its recovery
    assert readings[-1][0]["tokens"] == (6 + 6 + 3) * 32
    assert int(sim.states[1].step) == 6
    # no aliasing between pods after the merge
    a, b = (T.leaves(sim.states[i].params)[0] for i in (0, 1))
    assert a.data_ptr() != b.data_ptr()


if __name__ == "__main__":
    reference_runs(sys.argv[1], int(sys.argv[2]), sys.argv[3])
