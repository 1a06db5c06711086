"""The dry run (``repro_torch.launch.dryrun``) and what it needs, on the
CPU: the registry's ``cell_supported`` and ``decode_input_specs`` against
the JAX package's, each cell's argument bytes against the reference's
abstract inputs, the trace of a train step against a concrete CPU run of
the same step, the five kernels' shape-only routes, the ``--arch tpcc``
cell at tier-1 scale and the command line.

Exactness: verdicts, shapes, dtypes, bytes, FLOPs and op counts are
integers and are held equal. The one stated exception: on a shape's
first step whisper's encoder and decoder build their sinusoid tables on
the host and move them to the step's device (``whisper.sinusoid`` keeps
them after), a copy the trace (and the card) dispatches and a CPU run,
whose tables are already there, does not.
"""

import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.configs import registry as jregistry  # noqa: E402
from repro.models.config import SHAPES as JSHAPES  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels import (escrow_admit, flash_attention,  # noqa: E402
                                 ramp_read, rwkv6_scan, txn_megastep)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import whisper  # noqa: E402
from repro_torch.models.config import SHAPES, ShapeConfig  # noqa: E402
from repro_torch.txn import tpcc  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FAMILIES = ["smollm-360m", "olmoe-1b-7b", "rwkv6-3b", "hymba-1.5b",
            "llama-3.2-vision-11b", "whisper-tiny"]
HBM = 80 * 2 ** 30
TRAIN = ShapeConfig("tiny", 64, 4, "train")
# whisper's two sinusoid tables, moved to the device on a shape's first
# step (module note)
HOST_TABLES = {"whisper-tiny": collections.Counter({"aten._to_copy": 2})}


def _dtype_name(dt) -> str:
    return str(dt)[6:] if isinstance(dt, torch.dtype) else np.dtype(dt).name


# ---------------------------------------------------------------------------
# The registry's dry-run functions against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", registry.ARCHS)
def test_cell_supported_matches_reference(arch):
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    for name in SHAPES:
        assert registry.cell_supported(cfg, SHAPES[name]) == \
            jregistry.cell_supported(jcfg, JSHAPES[name]), (arch, name)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_input_specs_match_reference(arch):
    """Leaf for leaf at full width: the port's meta tensors against the
    reference's ShapeDtypeStructs; the KV cache's ``pos`` is a host int
    where the reference's is an int32 scalar."""
    cfg, jcfg = registry.get_config(arch), jregistry.get_config(arch)
    for name in ("decode_32k", "long_500k"):
        if not registry.cell_supported(cfg, SHAPES[name])[0]:
            continue
        cache, token = registry.decode_input_specs(cfg, SHAPES[name])
        jcache, jtoken = jregistry.decode_input_specs(jcfg, JSHAPES[name])
        got, want = T.leaves(cache), jax.tree.leaves(jcache)
        assert len(got) == len(want)
        for x, y in zip(got + [token], want + [jtoken]):
            if isinstance(x, int):
                assert x == 0 and y.shape == () and y.dtype == jnp.int32
                continue
            assert x.is_meta
            assert tuple(x.shape) == tuple(y.shape), (arch, name)
            assert _dtype_name(x.dtype) == _dtype_name(y.dtype), (arch, name)


def _nbytes(leaves) -> int:
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in leaves)


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_cell_argument_bytes_match_reference(arch):
    """A decode cell's ``argument_bytes``: the reference's abstract inputs
    (its ``_serving_params_abs``, ``launch/dryrun.py:80-88``, plus
    ``decode_input_specs`` plus the tokens), less the 4 bytes of each
    KV cache's ``pos``, which the port keeps on the host."""
    jcfg = jregistry.get_config(arch)
    dt = jnp.dtype(jcfg.dtype)
    params = jax.tree.map(
        lambda l: jax.ShapeDtypeStruct(l.shape, dt)
        if jnp.issubdtype(l.dtype, jnp.floating) else l,
        jregistry.abstract_params(jcfg))
    jcache, jtoken = jregistry.decode_input_specs(jcfg, JSHAPES["decode_32k"])
    pos = sum(1 for x in jax.tree.leaves(jcache) if x.shape == ())
    want = _nbytes(jax.tree.leaves(params) + jax.tree.leaves(jcache)
                   + [jtoken]) - 4 * pos
    cell = dryrun.run_cell(arch, "decode_32k", 1, HBM)
    assert cell["ok"], cell.get("trace")
    assert cell["memory"]["argument_bytes"] == want
    assert cell["fits"] == (cell["memory"]["peak_bytes"] <= HBM)
    assert cell["cost"]["flops"] > 0 and cell["ops"]["total"] > 0
    assert cell["collectives"]["counts"] == {}


# ---------------------------------------------------------------------------
# The trace against a concrete run of the same step
# ---------------------------------------------------------------------------


def _cpu_step(cfg, pods=1, **kw):
    setup = dryrun.train_setup(cfg, pods=pods, device="cpu", **kw)
    state = setup.init_fn(0)
    batch = registry.make_train_batch(torch.Generator().manual_seed(0), cfg,
                                      TRAIN.global_batch, TRAIN.seq_len)
    return setup, state, batch


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_trace_matches_a_cpu_run(arch):
    """A reduced train step traced on meta tensors and run on the CPU
    under the same counters: FLOPs, ops (kind by kind), argument bytes and
    the live-bytes peak equal (no kernel is on the path)."""
    cfg = registry.get_config(arch).reduced()
    whisper.sinusoid.cache_clear()   # each run builds its tables
    traced = dryrun.trace_train(cfg, TRAIN, 1)
    setup, state, batch = _cpu_step(cfg)
    ran, _ = dryrun.trace(setup.step_fn, (state, batch))
    assert traced["cost"]["flops"] == ran["cost"]["flops"] > 0
    got, want = (collections.Counter(r["ops"]["kinds"]) for r in (traced,
                                                                   ran))
    assert got - want == HOST_TABLES.get(arch, collections.Counter())
    assert not want - got
    for key in ("argument_bytes", "peak_bytes"):
        assert traced["memory"][key] == ran["memory"][key], key
    assert traced["collectives"]["counts"] == {}


def test_deferred_merge_trace_matches_a_cpu_run():
    """Two pods, hierarchical, the int8 merge: the traced merge's
    collectives (kinds, calls, bytes, all across pods) and FLOPs equal a
    CPU run's, and the step calls none."""
    cfg = registry.get_config("smollm-360m").reduced()
    kw = dict(coord_mode="hierarchical", compress="int8")
    traced = dryrun.trace_train(cfg, TRAIN, 2, **kw)
    setup, state, _ = _cpu_step(cfg, pods=2, **kw)
    ran, _ = dryrun.trace(setup.merge_fn, (state,), pods=2)
    assert traced["collectives"]["counts"] == {}
    merge = traced["merge"]["collectives"]
    assert merge == ran["collectives"]
    n = registry.exact_param_count(cfg)
    leaves = len(T.leaves(registry.abstract_params(cfg)))
    # params, mu and nu: an int8 all-gather of both pods and a pmax scalar
    # a leaf
    assert merge["counts"] == {"all-gather": 3 * leaves,
                               "all-reduce": 3 * leaves}
    assert merge["bytes"] == 3 * (2 * n + 4 * leaves)
    assert merge["cross_pod"] == 6 * leaves
    assert traced["merge"]["cost"]["flops"] == ran["cost"]["flops"]


# ---------------------------------------------------------------------------
# The kernels' shape-only routes
# ---------------------------------------------------------------------------


def _gen():
    return torch.Generator().manual_seed(0)


def _admission(g, B=12, L=15, A=40):
    avail0 = torch.randint(0, 30, (A,), generator=g, dtype=torch.int32)
    slot = torch.randint(0, A, (B, L), generator=g, dtype=torch.int32)
    qty = torch.randint(1, 10, (B, L), generator=g, dtype=torch.int32)
    lv = torch.rand((B, L), generator=g) < 0.7
    return avail0, slot, qty, lv


def _problem(kernel):
    """(entry, CPU arguments, keywords, the operations it states)."""
    g = _gen()
    if kernel == "escrow_admit":
        args = _admission(g)
        return ops.escrow_admit, args, {}, 0
    if kernel == "txn_megastep":
        avail0, slot, qty, lv = _admission(g)
        B, L = slot.shape
        i32 = lambda hi, *s: torch.randint(0, hi, s, generator=g,  # noqa
                                           dtype=torch.int32)
        local = torch.rand((B, L), generator=g) < 0.8
        args = (avail0, slot, qty, lv, i32(5, B), i32(30, B, L), local,
                ~local & lv, i32(100, B), torch.rand((B, L), generator=g))
        return (ops.txn_megastep, args, dict(n_keys=5, n_cells=30),
                txn_megastep.operations(B, L))
    if kernel == "ramp_read":
        R, L = 9, 15
        ts = torch.randint(0, 4, (R, L), generator=g, dtype=torch.int32)
        args = (torch.randint(0, 4, (R,), generator=g, dtype=torch.int32),
                torch.randint(5, 16, (R,), generator=g, dtype=torch.int32),
                ts, torch.rand((R, L), generator=g) < 0.6,
                torch.rand((R, L), generator=g) < 0.5,
                torch.rand((R, L), generator=g),
                torch.randint(0, 99, (R, L), generator=g, dtype=torch.int32))
        return ops.ramp_read_select, args, {}, ramp_read.operations(R, L)
    if kernel == "flash_attention":
        B, S, H, KV, hd = 2, 13, 6, 2, 16
        n = lambda h: torch.randn((B, S, h, hd), generator=g)  # noqa: E731
        return (ops.flash_attention, (n(H), n(KV), n(KV)), dict(causal=True),
                flash_attention.operations(B, S, H, hd, True))
    B, T_, H, hd = 2, 21, 3, 8
    n = lambda *s: torch.randn(s, generator=g)  # noqa: E731
    args = (n(B, T_, H, hd), n(B, T_, H, hd), n(B, T_, H, hd),
            torch.rand((B, T_, H, hd), generator=g) * 0.5 + 0.4,
            n(H, hd), n(B, H, hd, hd))
    return ops.rwkv6_scan, args, {}, rwkv6_scan.operations(B, T_, H, hd)


WRAPPERS = {"escrow_admit": escrow_admit.escrow_admit_cuda,
            "txn_megastep": txn_megastep.txn_megastep_cuda,
            "ramp_read": ramp_read.ramp_read_cuda,
            "flash_attention": flash_attention.flash_attention_cuda,
            "rwkv6_scan": rwkv6_scan.rwkv6_scan_cuda}


# txn_megastep's wrapper slices its count buffer in Python, which a torch
# built without CUDA cannot do on a CUDA tensor, fake or not: here its fake
# tensors lie on the meta device (the GPU file takes fake CUDA ones)
FAKE_DEVICE = {"txn_megastep": "meta"}


def _shapes(out):
    return [(tuple(x.shape), x.dtype) for x in out] \
        if isinstance(out, tuple) else [(tuple(out.shape), out.dtype)]


@pytest.mark.parametrize("kernel", list(WRAPPERS))
def test_shape_only_route(kernel):
    """A meta problem through the entry of ``kernels/ops.py``: the plain
    version's shapes and dtypes, the kernel's stated operations counted to
    FlopCounterMode (under its own op), nothing built, nothing launched.
    The same through the wrapper with fake CUDA tensors (FakeTensorMode):
    the shape-only route takes any tensor without data."""
    entry, args, kw, n_ops = _problem(kernel)
    want = _shapes(entry(*(x.clone() for x in args), **kw))
    wrapper = WRAPPERS[kernel]
    launches = wrapper.launches
    meta = [x.to("meta") for x in args]
    with FlopCounterMode(display=False) as fc:
        got = entry(*meta, **kw)
    assert _shapes(got) == want
    assert all(x.is_meta for x in (got if isinstance(got, tuple) else [got]))
    counts = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert counts == {f"repro_torch.{kernel}": n_ops}
    if kernel in ("escrow_admit", "txn_megastep"):
        # the wrapper takes the gate's outputs: compute them on the CPU
        fast = ops.contention_gate(*args[:4])[0]
        args = (*args[:4], fast, *ops.residual_order(fast), *args[4:])
    device = FAKE_DEVICE.get(kernel, "cuda")
    with FakeTensorMode():
        fake = [torch.empty(x.shape, dtype=x.dtype, device=device)
                for x in args]
        with FlopCounterMode(display=False) as fc:
            got = wrapper(*fake, **kw)
    got = got if isinstance(got, tuple) else (got,)
    assert all(x.device.type == device for x in got)
    assert fc.get_total_flops() == n_ops
    assert wrapper.launches == launches
    assert kernel not in build._loaded


def test_plain_entries_count_no_kernel_operations():
    """A CPU tensor keeps the plain version: no launch marker reaches
    FlopCounterMode (B5's plain version counts its own matmuls)."""
    entry, args, kw, _ = _problem("flash_attention")
    with FlopCounterMode(display=False) as fc:
        entry(*args, **kw)
    keys = {str(k) for k in fc.get_flop_counts()["Global"]}
    assert "repro_torch.flash_attention" not in keys and keys


def test_rwkv6_operations_are_the_chunked_forms_least():
    """The bound of B6's main problem (B 8, T 467, H 40, hd 64), and the
    search over chunk sizes, which stops at hd, against every size up to
    T."""
    assert rwkv6_scan.operations(8, 467, 40, 64) == 2_713_033_386
    assert flash_attention.operations(8, 467, 15, 64, True) == 3_357_020_160
    for T_, hd in ((5, 8), (100, 8), (40, 64), (467, 64), (3000, 128)):
        per = min(4 * hd * hd + hd * hd / C + 2 * (C + 1) * hd + 3 * hd
                  for C in range(1, T_ + 1))
        assert rwkv6_scan.operations(2, T_, 3, hd) == int(2 * 3 * T_ * per)


# ---------------------------------------------------------------------------
# --arch tpcc at tier-1 scale, and the command line
# ---------------------------------------------------------------------------


def _reference_escrow_audit(scale_kw) -> dict:
    """The reference's ``tpcc_escrow_audit_cell`` run (its body: the
    module itself sets a 512-device XLA flag at import)."""
    from jax.sharding import Mesh

    from repro.txn.audit import audit_tpcc
    from repro.txn.engine import Engine
    from repro.txn.engine import run_escrow_loop as jrun
    from repro.txn.tpcc import TPCCScale, init_state

    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    scale = TPCCScale(**scale_kw)
    eng = Engine(scale, mesh, ("data",), stock_invariant="strict",
                 hot_items=8)
    state = eng.shard_state(init_state(scale))
    q0 = state.s_quantity.copy()
    state, esc, st = jrun(eng, state, batch_per_shard=8, n_batches=6,
                          merge_every=2, refresh_every=2, seed=0, mix=False,
                          fused=False, item_skew=1.1)
    rep = audit_tpcc(state, escrow=esc, initial_stock=q0, strict_stock=True)
    return dict(committed=st.neworders, aborts=st.aborts,
                refreshes=st.refreshes, cold_rejects=st.cold_rejects,
                audit_ok=rep.ok)


def test_tpcc_cell_at_tier1_on_the_cpu():
    scale = tpcc.TPCCScale(**dryrun.TIER1)
    cell = dryrun.tpcc_cell(shards=2, device="cpu", scale=scale)
    assert cell["ok"], cell.get("trace")
    hot = ["neworder", "order_status", "stock_level", "fused_megastep",
           "escrow_neworder", "escrow_megastep", "escrow_admission",
           "megastep_fused", "obs_megastep_metrics", "obs_record"]
    for name in hot:
        assert cell[name]["collectives"]["counts"] == {}, name
        assert cell[name]["run"]["kind"] == "traced"
    assert cell["escrow_refresh"]["collectives"]["counts"]["all-reduce"] > 0
    assert cell["obs_ledger"]["hot_collectives"] == 0
    assert all(w["tile"] == w["batch"] for w in cell["walk"])
    # the kernels' operations reached the counter through their markers
    assert "repro_torch.txn_megastep" in cell["megastep_fused"]["cost"][
        "by_op"]
    assert "repro_torch.ramp_read" in cell["order_status"]["cost"]["by_op"]
    audit = cell["escrow_audit"]
    assert audit["run"]["kind"] == "concrete" and audit["audit_ok"]
    want = _reference_escrow_audit(dryrun.TIER1)
    assert {k: audit[k] for k in want} == want
    # the spec-scale layout claim the full cell asserts
    spec = tpcc.TPCCScale.spec_scale(512)
    assert tpcc.escrow_layout_bytes(spec, tpcc.default_hot_items(spec))[
        "reduction_vs_dense"] >= 50


def test_cli_one_arch_both_pod_counts(tmp_path):
    """The reference's ``test_dryrun_single_cell_both_meshes``, on one
    card: whisper-tiny at three shapes on 1 and 2 pods, long_500k a
    designed skip."""
    out = tmp_path / "cells.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "whisper-tiny", "--shape", "train_4k,decode_32k,long_500k",
         "--pods", "both", "--device", "cpu", "--out", str(out)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    cells = json.loads(out.read_text())
    assert len(cells) == 6 and all(c["ok"] for c in cells)
    assert [c["pods"] for c in cells] == [1, 1, 1, 2, 2, 2]
    for c in cells:
        if c["shape"] == "long_500k":
            assert c["skipped"] and "512k" in c["reason"]
            continue
        assert {"memory", "fits", "cost", "ops", "collectives"} <= set(c)
        assert c["memory"]["peak_bytes"] >= c["memory"]["argument_bytes"]
