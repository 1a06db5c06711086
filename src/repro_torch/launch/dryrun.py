"""One-card dry run: trace every (architecture x input shape) cell and the
spec-scale TPC-C paths on fake tensors, allocating nothing, and record
what each step would cost the card — the port of ``repro.launch.dryrun``.

The reference lowers and compiles every cell on 256- and 512-chip meshes
and reads XLA's analyses. The port runs the same step functions eagerly
on fake tensors (``FakeTensorMode``) at the published widths and shapes,
under three counters:

  * a live-bytes tracker (:class:`StepTrace`), the analogue of
    ``memory_analysis()``: the arguments' bytes, the outputs' and the
    high-water mark of every tensor alive during the step, each storage
    rounded up to the CUDA caching allocator's 512-byte block — against
    the card's memory (``fits``);
  * ``FlopCounterMode``, the analogue of ``cost_analysis()``: the
    matmuls' FLOPs, and for a kernel of the port the operations its
    launch marker reports (``kernels/build.launch_marker``: B5 skips the
    masked half, B6 counts its chunked form);
  * the same tracker's op counter, the aten ops a step dispatches (the
    eager step's analogue of ``hlo.count_ops``), and
    ``txn/collectives.counted()``, the analogue of the HLO collective
    inventory (``hlo.collective_stats``, ``cross_pod_collectives``).

A kernel entry given a fake tensor takes the kernel's shape-only route:
its outputs' shapes and dtypes, its operations counted, nothing built and
nothing launched. The fake tensors live on the meta device: a build of
torch without CUDA cannot index a CUDA tensor, fake or not (the indexing
takes a CUDA device guard), and every kernel entry sends a meta tensor to
the shape-only route as it would a fake CUDA one.

A cell counts its step as the step's first call in the process makes
it: whisper's sinusoid tables, built on a shape's first step and kept
after (``models/whisper.sinusoid``), add their copies to the first cell
of that shape only.

Which step a cell traces, by shape kind: ``train`` — ``optim.coord``'s
``step_fn`` at the shape's global batch and sequence (sync, remat,
``AdamWConfig(clip_mode="escrow")``, plain attention), and ``merge_fn``
where the coord mode defers; ``prefill`` — ``registry.make_prefill_fn``
on serving weights in the compute dtype (B5 and B6 on their shape-only
routes); ``decode`` and ``long_decode`` — ``registry.make_decode_fn`` on
``registry.decode_input_specs``. A cell ``cell_supported`` rejects is a
designed skip (``ok``); a cell that does not fit one card is ``ok`` with
``fits: false``.

``--arch tpcc`` (:func:`tpcc_cell`) holds the port's coordination claims
at spec scale (``configs/tpcc.config()``, 512 warehouses) on ``--shards``
shards: New-Order, Order-Status, Stock-Level, the fused chunk and its
escrow twin, the escrow New-Order with the admission kernel and with the
fused effects, and the metrics-on escrow chunk with its record each call
no collective, traced on fake tables; the escrow refresh calls some; the
sparse escrow layout is at least 50x under dense; the admission walk's
tile fits its shared-memory budget at spec batch; a coordination ledger
holds zero hot collectives; and a concrete tier-1 escrow run passes its
audit, on ``--device``.

Left out, on purpose: ``utils/compat.py`` (JAX-version shims);
``launch/mesh.py`` (the 256- and 512-chip meshes: ``--pods`` and
``--shards`` take their place on one card); ``models/sharding.py``
(``Rules`` is the identity on one card, and the partition specs have no
eager counterpart); ``utils/hlo.py`` (there is no HLO: the op counter and
``collectives.counted()`` count the eager calls one by one, so no loop
scaling is needed); and the reference's ``--layout sp`` (a sequence
layout across a mesh axis has no meaning on one card).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --pods both --device cpu --out dryrun.json
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tpcc
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import registry
from repro_torch.core import tree as T
from repro_torch.models import layers as L
from repro_torch.models.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.txn import collectives

TRACE_DEVICE = torch.device("meta")
# metadata queries, not ops of the step: a fake tensor's device policy
# dispatches them where a real tensor answers in C++ (FlopCounterMode
# passes over the same set)
_QUERIES = {torch.ops.prim.device.default, torch.ops.prim.layout.default,
            torch.ops.aten.is_contiguous.default,
            torch.ops.aten.is_contiguous.memory_format,
            torch.ops.aten.is_strides_like_format.default,
            torch.ops.aten.is_non_overlapping_and_dense.default,
            torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
            torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
            torch.ops.aten.storage_offset.default,
            torch.ops.aten.sym_storage_offset.default,
            torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
            torch.ops.aten.dim.default}
BLOCK = 512        # bytes: the CUDA caching allocator rounds each block up
TOP_OPS = 8        # op kinds listed by count in a cell
HBM_GB = 80        # an H100's memory, the CPU's stand-in for the card's


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------


def _storage_bytes(tensors) -> int:
    """Exact bytes of the distinct storages of ``tensors``."""
    seen = {}
    for t in tensors:
        st = t.untyped_storage()
        seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _tensors(tree) -> list:
    return [x for x in T.leaves(tree) if isinstance(x, torch.Tensor)]


class StepTrace(TorchDispatchMode):
    """The ops a step dispatches (``ops``, a count a kind, metadata
    queries left out) and the bytes it holds: every storage a dispatched
    op returns is live, rounded up to :data:`BLOCK`, until its last tensor
    dies; ``peak`` is the high-water mark, arguments (:meth:`hold`)
    included. The same mode counts a real run on the card."""

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter = collections.Counter()
        self.live = 0
        self.peak = 0
        self._refs: dict = {}

    def hold(self, tensors) -> None:
        """Count ``tensors``, which exist before the step, as live."""
        for t in tensors:
            self._track(t)
        self.peak = max(self.peak, self.live)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = -(-st.nbytes() // BLOCK) * BLOCK
        self.live += n
        self._refs[key] = weakref.ref(
            st, lambda _, key=key, n=n: self._free(key, n))

    def _free(self, key, n: int) -> None:
        self.live -= n
        self._refs.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _QUERIES:
            return out
        self.ops[str(func.overloadpacket)] += 1
        for t in _tensors(out):
            self._track(t)
        self.peak = max(self.peak, self.live)
        return out


def ops_record(ops: collections.Counter) -> dict:
    return {"total": sum(ops.values()),
            "top": dict(ops.most_common(TOP_OPS)), "kinds": dict(ops)}


def collectives_record(stats: collectives.CollectiveStats, pods: int
                       ) -> dict:
    """The collectives a step called; with more than one pod every one of
    them crosses pods (the port's only collectives are the cross-pod and
    cross-shard ones of ``txn/collectives.py``)."""
    out = {"counts": dict(stats.counts), "bytes": sum(stats.bytes.values()),
           "bytes_by_kind": dict(stats.bytes), "describe": stats.describe()}
    if pods > 1:
        out["cross_pod"] = stats.total_ops
        out["cross_pod_bytes"] = out["bytes"]
    return out


def trace(fn, args: tuple, *, pods: int = 1) -> tuple[dict, object]:
    """``fn(*args)`` under the counters (on meta tensors: the trace;
    on the card: the measured run a trace is held to). Returns (the record
    — memory, cost, ops, collectives — and the output)."""
    step = StepTrace()
    t0 = time.perf_counter()
    held = _tensors(args)
    with FlopCounterMode(display=False) as flops, \
            collectives.counted() as coll:
        with step:
            step.hold(held)
            start = step.live
            out = fn(*args)
    outs = _tensors(out)
    rec = {
        "memory": {"argument_bytes": _storage_bytes(held),
                   "output_bytes": _storage_bytes(outs),
                   "temp_bytes": step.peak - start,
                   "peak_bytes": step.peak},
        "cost": {"flops": flops.get_total_flops(),
                 "by_op": {str(k): v for k, v in
                           flops.get_flop_counts()["Global"].items()}},
        "ops": ops_record(step.ops),
        "collectives": collectives_record(coll, pods),
        "trace_seconds": round(time.perf_counter() - t0, 3),
    }
    return rec, out


# ---------------------------------------------------------------------------
# The model cells
# ---------------------------------------------------------------------------


def serving_params_abs(cfg: ModelConfig) -> dict:
    """Serving lowers weights in the compute dtype, not float32 masters
    (the reference's ``_serving_params_abs``): the stacked tree as meta
    tensors."""
    dt = L.dtype_of(cfg)
    return T.map(lambda x: x.to(dt) if x.is_floating_point() else x,
                 registry.abstract_params(cfg))


def prefill_step(cfg: ModelConfig):
    """``(params, batch) -> output``: the family's prefill over the
    stacked serving tree (bound inside the step, as training binds)."""
    fn = registry.make_prefill_fn(cfg)
    return lambda params, batch: fn(L.bind(params), batch)


def decode_step(cfg: ModelConfig):
    """``(params, cache, token) -> (logits, cache)`` over the stacked
    serving tree."""
    fn = registry.make_decode_fn(cfg)
    return lambda params, cache, token: fn(L.bind(params), cache, token)


def prefill_inputs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    batch = registry.train_input_specs(cfg, shape)
    batch.pop("labels")
    return batch


def train_setup(cfg: ModelConfig, *, pods: int = 1, coord_mode: str = "sync",
                merge_every: int = 8, compress: str = "none",
                remat: bool = True, microbatch: int = 1, device=None):
    """The training setup a train cell traces: ``coord.build`` with the
    reference's defaults (escrow clipping, plain attention)."""
    from repro_torch.optim import adamw, coord

    cc = coord.CoordConfig(mode=coord_mode, merge_every=merge_every,
                           compress=compress, microbatch=microbatch)
    return coord.build(
        cfg, cc, adamw.AdamWConfig(clip_mode="escrow"),
        lambda c: registry.make_loss_fn(c, use_flash=False, remat=remat),
        n_pods=pods, device=TRACE_DEVICE if device is None else device)


def trace_train(cfg, shape, pods, **kw) -> dict:
    setup = train_setup(cfg, pods=pods, **kw)
    state = setup.abstract_state
    rec, _ = trace(setup.step_fn,
                   (state, registry.train_input_specs(cfg, shape)),
                   pods=pods)
    if setup.merge_fn is not None:
        rec["merge"], _ = trace(setup.merge_fn, (state,), pods=pods)
    return rec


def trace_prefill(cfg, shape, pods) -> dict:
    rec, _ = trace(prefill_step(cfg), (serving_params_abs(cfg),
                                       prefill_inputs(cfg, shape)),
                   pods=pods)
    return rec


def trace_decode(cfg, shape, pods) -> dict:
    cache, token = registry.decode_input_specs(cfg, shape)
    rec, _ = trace(decode_step(cfg), (serving_params_abs(cfg), cache, token),
                   pods=pods)
    return rec


def apply_overrides(cfg: ModelConfig, overrides: str) -> ModelConfig:
    """--set key=value[,key=value...] config overrides (perf iterations)."""
    if not overrides:
        return cfg
    kv = {}
    for pair in overrides.split(","):
        k, v = pair.split("=")
        if v.lower() in ("true", "false"):
            v = v.lower() == "true"
        else:
            try:
                v = int(v)
            except ValueError:
                try:
                    v = float(v)
                except ValueError:
                    pass
        kv[k] = v
    return dataclasses.replace(cfg, **kv)


def run_cell(arch: str, shape_name: str, pods: int, hbm_bytes: int,
             coord_mode: str = "sync", remat: bool = True,
             overrides: str = "", merge_every: int = 8,
             compress: str = "none", microbatch: int = 1) -> dict:
    """One (arch x shape) cell on ``pods`` pods: its record, ``ok`` unless
    the trace failed."""
    cell = {"arch": arch, "shape": shape_name, "pods": pods,
            "coord_mode": coord_mode, "overrides": overrides}
    cfg = apply_overrides(registry.get_config(arch), overrides)
    shape = SHAPES[shape_name]
    ok, why = registry.cell_supported(cfg, shape)
    if not ok:
        cell.update(ok=True, skipped=True, reason=why)
        return cell
    try:
        if shape.kind == "train":
            rec = trace_train(cfg, shape, pods, coord_mode=coord_mode,
                              merge_every=merge_every, compress=compress,
                              remat=remat, microbatch=microbatch)
        elif shape.kind == "prefill":
            rec = trace_prefill(cfg, shape, pods)
        else:
            rec = trace_decode(cfg, shape, pods)
        cell.update(rec)
        peak = max(rec["memory"]["peak_bytes"],
                   rec.get("merge", rec)["memory"]["peak_bytes"])
        cell.update(fits=peak <= hbm_bytes, hbm_bytes=hbm_bytes, ok=True)
    except Exception as e:
        cell.update(ok=False, error=f"{type(e).__name__}: {e}",
                    trace=traceback.format_exc()[-2000:])
    return cell


# ---------------------------------------------------------------------------
# --arch tpcc: the paper's own workload at spec scale
# ---------------------------------------------------------------------------

TPCC_BATCH = 16          # New-Orders a shard a batch (the reference's)
TPCC_CHUNK = 4           # steps a fused chunk (the reference's)
DEPLOYMENT_BATCH = 256   # New-Orders a batch of the card's deployment
TIER1 = dict(n_warehouses=4, districts=4, customers=8, n_items=64,
             order_capacity=128, max_lines=15)   # the audit run's scale


def to_meta(tree):
    """``tree`` with each tensor leaf a meta tensor of its shape and
    dtype."""
    return T.map(lambda x: torch.empty_like(x, device=TRACE_DEVICE)
                 if isinstance(x, torch.Tensor) else x, tree)


def _no_collectives(name: str, rec: dict) -> None:
    if rec["collectives"]["counts"]:
        raise AssertionError(f"{name} calls collectives at spec scale: "
                             f"{rec['collectives']['describe']}")


def tpcc_paths(scale, shards: int, batch_per_shard: int = TPCC_BATCH,
               chunk_len: int = TPCC_CHUNK) -> dict:
    """Every TPC-C path of the claims, traced on meta tables of ``scale``
    on ``shards`` shards. Returns ({path: record}, the escrow layout's
    bytes a device)."""
    from repro_torch.obs import metrics as obsm
    from repro_torch.txn import tpcc
    from repro_torch.txn.drivers import generate_mix_batches
    from repro_torch.txn.engine import Engine
    from repro_torch.txn.executor import FusedExecutor, OkBuffer, stack_chunks

    dev = TRACE_DEVICE
    state = tpcc.state_shape_dtypes(scale)
    read = max(1, batch_per_shard // 4)
    eng = Engine(scale, device=dev, n_shards=shards)
    # the batches are drawn on the host (Payment's rounds read them), then
    # traced as meta tensors
    no_b, pay_b, os_b, sl_b = generate_mix_batches(
        Engine(scale, device="cpu", n_shards=shards),
        batch_per_shard=batch_per_shard, n_batches=chunk_len,
        remote_frac=0.5, read_frac=read / batch_per_shard, seed=0)
    chunk = to_meta(stack_chunks(no_b, pay_b, os_b, sl_b, chunk_len)[0])
    no_b, os_b, sl_b = (to_meta(b[0]) for b in (no_b, os_b, sl_b))
    escrow = lambda **kw: Engine(scale, stock_invariant="strict",  # noqa
                                 device=dev, n_shards=shards, **kw)
    eng_escrow = escrow(admission="scan")
    eng_admit = escrow(admission="kernel", effects="scan")
    eng_fused = escrow(admission="kernel", effects="fused")
    esc = eng_escrow.init_escrow(state)

    def chunk_of(engine, metrics=False):
        """The fused executor's chunk body: what its CUDA graph captures
        (phase 19 runs the capture on the card)."""
        ex = FusedExecutor(engine, ring_rows=chunk_len)
        ring, counters = ex.init_ring(batch_per_shard), ex.init_counters()
        e = esc if engine is not eng else None
        oks = None
        if metrics:
            oks = OkBuffer(torch.zeros((1, chunk_len,
                                        chunk.neworder.w.shape[1]),
                                       dtype=torch.bool, device=dev),
                           torch.zeros((1,), dtype=torch.int64, device=dev))
        return lambda: ex._chunk(state, ring, counters, e, chunk, oks)

    paths = {
        "neworder": lambda: eng.neworder_step(state, no_b),
        "order_status": lambda: eng.order_status_step(state, os_b),
        "stock_level": lambda: eng.stock_level_step(state, sl_b),
        "fused_megastep": chunk_of(eng),
        "escrow_neworder": lambda: eng_escrow.neworder_escrow_step(
            state, esc, no_b),
        "escrow_megastep": chunk_of(eng_escrow),
        "escrow_admission": lambda: eng_admit.neworder_escrow_step(
            state, esc, no_b),
        "megastep_fused": lambda: eng_fused.neworder_escrow_step(
            state, esc, no_b),
        "obs_megastep_metrics": chunk_of(eng_escrow, metrics=True),
        "obs_record": lambda: obsm.record_chunk(
            obsm.init_obs_metrics(eng_escrow), chunk.neworder,
            torch.ones(chunk.neworder.w.shape, dtype=torch.bool,
                       device=dev)),
        "escrow_refresh": lambda: eng_escrow.refresh_escrow(state, esc),
    }
    live = (state, esc, chunk, no_b, os_b, sl_b)
    out = {}
    for name, fn in paths.items():
        out[name], _ = trace(lambda *_: fn(), live, pods=shards)
        out[name]["run"] = dict(kind="traced", scale=dataclasses.asdict(
            scale), shards=shards, batch_per_shard=batch_per_shard)
    # the availability vector the admission walk reads (hot headroom, the
    # shard's cold stock, the remote sentinel)
    A = eng_admit.hot_keys.shape[0] + eng_admit.w_per_shard * scale.n_items \
        + 1
    out["escrow_admission"].update(avail_cells=A, avail_bytes=4 * A)
    return out, eng_escrow.escrow_bytes_per_device()


def walk_record(batch: int, lines: int) -> dict:
    """B1's and B2's walk tile at ``batch`` transactions of ``lines``
    lines (``kernels/escrow_admit.walk_shape``): the batch must be one
    tile whose shared memory fits ``WALK_SMEM_BUDGET``, so the whole walk
    stays in shared memory — the counterpart of the reference's 16 MB
    VMEM checks."""
    from repro_torch.kernels.escrow_admit import WALK_SMEM_BUDGET, walk_shape

    T_, H, smem = walk_shape(batch, lines)
    rec = dict(batch=batch, lines=lines, tile=T_, table=H, smem_bytes=smem,
               smem_budget=WALK_SMEM_BUDGET)
    if T_ < batch or smem > WALK_SMEM_BUDGET:
        raise AssertionError(f"the admission walk at batch {batch} is not "
                             f"one tile in its shared-memory budget: {rec}")
    return rec


def escrow_audit(device) -> dict:
    """A small concrete escrow run and its consistency audit on
    ``device``: tier-1 scale (:data:`TIER1`), strict stock and escrow
    conservation checked by the independent oracle (``txn/audit.py``) —
    the reference's ``tpcc_escrow_audit_cell``."""
    from repro_torch.txn.audit import audit_tpcc
    from repro_torch.txn.drivers import run_escrow_loop
    from repro_torch.txn.engine import Engine
    from repro_torch.txn.tpcc import TPCCScale, init_state

    scale = TPCCScale(**TIER1)
    eng = Engine(scale, stock_invariant="strict", hot_items=8, device=device)
    state = eng.shard_state(init_state(scale, device=eng.device))
    q0 = state.s_quantity.clone()
    state, esc, stats = run_escrow_loop(
        eng, state, batch_per_shard=8, n_batches=6, merge_every=2,
        refresh_every=2, seed=0, mix=False, fused=False, item_skew=1.1)
    rep = audit_tpcc(state, escrow=esc, initial_stock=q0, strict_stock=True)
    return dict(run=dict(kind="concrete", scale=TIER1,
                         device=str(eng.device)),
                committed=stats.neworders, aborts=stats.aborts,
                refreshes=stats.refreshes, cold_rejects=stats.cold_rejects,
                escrow_layout=eng.escrow_layout, audit_ok=rep.ok,
                audit_failures=rep.failures)


def tpcc_cell(shards: int = 4, device=None, scale=None) -> dict:
    """``--arch tpcc``: the coordination claims at spec scale
    (``configs/tpcc.config()``, or ``scale``) on ``shards`` shards, then
    the concrete audit run on ``device``. ``ok`` unless a claim fails; the
    sparse layout's 50x is a claim at the spec's cardinalities only."""
    from repro_torch.configs.tpcc import config as tpcc_config
    from repro_torch.obs.ledger import CoordinationLedger

    scale = tpcc_config() if scale is None else scale
    spec = scale == tpcc_config(scale.n_warehouses)
    cell = {"arch": "tpcc", "shape": "-", "shards": shards,
            "warehouses": scale.n_warehouses}
    try:
        paths, mem = tpcc_paths(scale, shards)
        hot = [k for k in paths if k != "escrow_refresh"]
        for name in hot:
            _no_collectives(name, paths[name])
        if not paths["escrow_refresh"]["collectives"]["counts"]:
            raise AssertionError("the escrow refresh must communicate")
        cell.update(paths, escrow_layout=mem)
        if mem["layout"] != "sparse" or (
                spec and mem["reduction_vs_dense"] < 50):
            raise AssertionError(f"the spec-scale escrow layout is not "
                                 f"sparse at >= 50x under dense: {mem}")
        cell["walk"] = [walk_record(b, scale.max_lines)
                        for b in (TPCC_BATCH, DEPLOYMENT_BATCH)]
        stats = lambda r: collectives.CollectiveStats(  # noqa: E731
            collections.Counter(r["collectives"]["counts"]),
            collections.Counter(r["collectives"]["bytes_by_kind"]))
        led = CoordinationLedger(
            context=f"spec-scale escrow, metrics-on, {shards} shards")
        led.add("megastep (hot scan)", stats(paths["obs_megastep_metrics"]),
                hot=True)
        led.add("metrics record", stats(paths["obs_record"]), hot=True)
        led.assert_budget()
        cell["obs_ledger"] = led.snapshot()
        cell["escrow_audit"] = escrow_audit(device)
        if not cell["escrow_audit"]["audit_ok"]:
            raise AssertionError(f"escrow audit failed: "
                                 f"{cell['escrow_audit']}")
        peak = max(r["memory"]["peak_bytes"] for r in paths.values())
        cell.update(peak_bytes=peak, ok=True)
    except Exception as e:
        cell.update(ok=False, error=f"{type(e).__name__}: {e}",
                    trace=traceback.format_exc()[-2000:])
    return cell


def hbm_bytes(device, hbm_gb: float | None) -> int:
    """The card's memory (``torch.cuda.get_device_properties``), or
    ``hbm_gb`` GiB where given or where the run is on the CPU."""
    if hbm_gb is None and device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return int((HBM_GB if hbm_gb is None else hbm_gb) * 2 ** 30)


def main(argv=None) -> int:
    from repro_torch.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id, comma list, 'all', or 'tpcc'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--pods", default="both", choices=["1", "2", "both"],
                    help="pods of a train cell on the one card (the "
                         "reference's --mesh single/multi)")
    ap.add_argument("--coord", default="sync",
                    choices=["sync", "hierarchical", "local_sgd"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--set", dest="overrides", default="",
                    help="config overrides, e.g. attn_impl=chunked")
    ap.add_argument("--merge-every", type=int, default=8)
    ap.add_argument("--compress", default="none")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--shards", type=int, default=4,
                    help="TPC-C shards on the one card (--arch tpcc)")
    ap.add_argument("--device", default=None,
                    help="where the concrete runs go and whose memory "
                         "`fits` reads (default: the CUDA card)")
    ap.add_argument("--hbm-gb", type=float, default=None,
                    help="the card's memory in GiB (default: the card's "
                         "own; 80 under --device cpu)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    hbm = hbm_bytes(device, args.hbm_gb)
    archs = list(registry.ARCHS) if args.arch == "all" \
        else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    pods = {"1": [1], "2": [2], "both": [1, 2]}[args.pods]

    results = []
    t0 = time.perf_counter()
    if "tpcc" in archs:
        cell = tpcc_cell(args.shards, device)
        cell["fits"] = cell.get("peak_bytes", 0) <= hbm
        results.append(cell)
        print(json.dumps({k: v for k, v in cell.items()
                          if k != "trace"})[:400], flush=True)
    for n in pods:
        for arch in (a for a in archs if a != "tpcc"):
            for shape_name in shapes:
                cell = run_cell(arch, shape_name, n, hbm,
                                coord_mode=args.coord,
                                remat=not args.no_remat,
                                overrides=args.overrides,
                                merge_every=args.merge_every,
                                compress=args.compress,
                                microbatch=args.microbatch)
                results.append(cell)
                print(json.dumps({k: v for k, v in cell.items()
                                  if k != "trace"})[:600], flush=True)

    n_fail = sum(1 for c in results if not c.get("ok"))
    print(f"\n{len(results)} cells, {n_fail} failures in "
          f"{time.perf_counter() - t0:.1f} s")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
