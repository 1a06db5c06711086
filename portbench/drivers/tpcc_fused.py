"""TPC-C through ``repro_torch``'s fused executor: set-up, the timed
window of passes, the traced passes and the check against the reference.

The configuration's ``n_shards`` (R) shards the warehouses as the port's
``Engine(n_shards=R)`` does, shard r the block of rows ``[r * W / R,
(r + 1) * W / R)`` of every table, and every batch is R home-partitioned
parts (``frozen/tpcc_inputs.py``). The merge regime takes any R that
divides W and the batch; the escrow regime takes R = 1 alone, since its
reference has no per-replica shares.

Set-up (all of it in ``setup_s``): the initial tables' draws and the
instance's pass stream on the host (``frozen/tpcc_inputs.py``), the
judged pass's stream from the seed, the tables on the device with the
spec's initial orders (TPC-C clause 4.3.3.1, drawn on the device from the
seed) and a snapshot of them, the engine as the configuration says, both
streams stacked into chunks with ``stack_chunks``, and one warm call of
the executor, which builds the kernels, captures and runs a pass.

The window: a fixed number of passes, ``seconds`` over the traffic's
``pass_seconds`` (a pass's time on the card this benchmark was sized on),
then the judged pass (with ``trace``, the profiled passes, which run the
judged stream). The count follows from the arguments alone, so a run's
transactions, commits and aborts do not depend on the program's speed; a
faster program ends its window sooner. Each pass restores
the snapshot in place (outside the clock) and makes one call of
``FusedExecutor.run`` (merge) or ``run_escrow`` (escrow) with
``warmup=False``. Every pass but the judged one runs the instance's
stream, so each does the same work and ends in the same state, however
fast the program runs.

After the window the program's tables after the judged pass, every
pass's counters and the escrow are read back with the initial tables;
the device state is freed; the reference replays the judged pass on the
host and ``reference/judge.py`` compares.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import time
from types import SimpleNamespace

import numpy as np

from portbench.frozen import kernel_bytes, tpcc_inputs
from portbench.reference import judge as judge_mod
from portbench.reference.tpcc_np import written_slots

# a window's committed transactions: the types MixStats.committed sums
COMMITTED = ("neworders", "payments", "order_statuses", "stock_levels",
             "deliveries")
# the spans that close a window: the drain, or the drain with the refresh
DRAINS = ("outbox-drain", "share-refresh")

# the escrow deployments' New-Order path: kernel B2's admission and fused
# effects
ADMISSION, EFFECTS = "kernel", "fused"
# the instance every seed relabels: the timed passes' tables and stream
INSTANCE_SEED = 20260530
# a traffic file's keys where it names none: 256 New-Orders a batch, 1%
# remote lines, passes of 64 batches in chunks of 8, a drain after each
# chunk and the share refresh with every drain; a window of ``seconds``
# over ``pass_seconds`` passes (a New-Order pass took 0.28-0.33 s on an
# H100 80GB HBM3 at 700 W)
TRAFFIC = dict(batch=256, batches_per_pass=64, merge_every=8,
               refresh_every=1, remote_frac=0.01, item_skew=0.0,
               payments=False, reads=False, read_frac=0.25,
               deliveries=False, trace_passes=3, pass_seconds=0.3)

# the order tables (ring-buffered per district) and their empty fill
ORDER_FILL = {
    "o_valid": False, "o_c_id": 0, "o_ol_cnt": 0, "o_carrier": -1,
    "o_entry_d": 0, "no_valid": False, "o_ts": -1, "ol_valid": False,
    "ol_i_id": 0, "ol_supply_w": 0, "ol_qty": 0, "ol_amount": 0.0,
    "ol_delivered": False, "ol_ts": -1, "ol_vis": False}
LINE_COLUMNS = {"ol_valid", "ol_i_id", "ol_supply_w", "ol_qty", "ol_amount",
                "ol_delivered", "ol_ts", "ol_vis"}


class _Hooks:
    """What the executor's ``obs`` argument is handed: spans from an
    ``ObsSession`` when the run traces (else none); on the card a CUDA
    event where each window's "megastep" span opens and one where its
    drain's span closes, so a window's time holds the host's gaps inside
    it; and after each chunk a copy on the device of the running committed
    counts, so each window's commits are known without a host read in the
    loop."""

    wants_metrics = False

    def __init__(self, torch, session, n_chunks: int, device):
        self._torch = torch
        self.session = session
        self.cuda = device.type == "cuda"
        self.buf = torch.zeros((n_chunks, len(COMMITTED)), dtype=torch.int64,
                               device=device)
        self.i = 0
        self.events: list[list] = []

    def _event(self):
        ev = self._torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @contextlib.contextmanager
    def span(self, phase: str):
        if self.cuda and phase == "megastep":
            self.events.append([self._event()])
        with (contextlib.nullcontext() if self.session is None
              else self.session.span(phase)):
            yield
        if self.cuda and phase in DRAINS:
            self.events[-1].append(self._event())

    def maybe_sync(self, value):
        if type(value).__name__ == "MixCounters":
            t = self._torch
            t.sum(t.stack([getattr(value, k) for k in COMMITTED]), 1,
                  out=self.buf[self.i])
            self.i += 1
        if self.session is not None:
            self.session.maybe_sync(value)
        return value

    def window_commits(self) -> list[int]:
        cum = self.buf[:self.i].cpu().numpy().sum(1)
        return np.diff(np.concatenate([[0], cum])).tolist()

    def window_ms(self) -> list:
        """Each window's milliseconds by the events (None off the card);
        read after the executor's closing synchronise."""
        if not self.cuda:
            return [None] * self.i
        return [a.elapsed_time(b) for a, b in self.events]


def traffic_of(traffic: dict) -> dict:
    """A traffic file's parameters over the defaults it leaves out."""
    return {**TRAFFIC, **traffic}


def window_passes(traffic: dict, seconds: float) -> int:
    """The instance's passes in a window of ``seconds``: a fixed count,
    at least one."""
    return max(1, round(seconds / traffic_of(traffic)["pass_seconds"]))


def make_inputs(cfg: dict, traffic: dict, seed: int):
    """(scale, initial draws, the instance's stream, the judged stream).
    The initial draws and the instance's stream come from
    ``INSTANCE_SEED`` and ``seed`` relabels them (``tpcc_inputs.relabel``,
    within each shard): every seed does the same work in the timed
    passes, in another layout. The judged pass's stream is drawn from
    ``seed``. Both streams stamp their New-Orders after the initial
    orders'. ``SystemExit`` where the reference does not cover the
    configuration."""
    R = cfg["n_shards"]
    if cfg.get("escrow_layout", "sparse") != "sparse":
        raise SystemExit(f"portbench: configuration {cfg['name']!r}: "
                         "tpcc_fused and its reference cover the sparse "
                         "escrow layout alone")
    if cfg["regime"] == "escrow" and R != 1:
        raise SystemExit(f"portbench: configuration {cfg['name']!r}: the "
                         f"escrow regime at {R} shards needs per-replica "
                         "shares, admission against each replica's share "
                         "and the cross-replica refresh in the reference")
    traffic = traffic_of(traffic)
    scale = tpcc_inputs.Scale(**cfg["scale"])
    tpcc_inputs.check_shards(scale, traffic["batch"], R, cfg["name"])
    draws = tpcc_inputs.initial_draws(
        scale, tpcc_inputs.rng_for(INSTANCE_SEED, 0), cfg["stock_multiplier"])

    def stream(rng):
        return tpcc_inputs.pass_stream(
            rng, scale, batch=traffic["batch"],
            n_batches=traffic["batches_per_pass"],
            remote_frac=traffic["remote_frac"],
            item_skew=traffic["item_skew"], payments=traffic["payments"],
            reads=traffic["reads"], read_frac=traffic["read_frac"],
            ts0=scale.customers, n_shards=R)

    draws, instance = tpcc_inputs.relabel(
        scale, draws, stream(tpcc_inputs.rng_for(INSTANCE_SEED, 1)),
        tpcc_inputs.rng_for(seed, 2), R)
    return scale, draws, instance, stream(tpcc_inputs.rng_for(seed, 3))


def _generator(torch, seed: int, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(int(tpcc_inputs.rng_for(seed, 4).integers(2**62)))
    return g


def device_tables(torch, draws, scale, dev, seed: int) -> dict:
    """The initial tables on the device, as TPC-C clause 4.3.3.1 populates
    them: the drawn columns; a warehouse's and a district's year-to-date
    and a customer's balance, payment and history after one payment of
    10.00 each; one order a customer a district (``o_c_id`` a random
    permutation), 5-15 lines of quantity 5 from the home warehouse, the
    last 30% undelivered (their lines' amounts drawn, the others 0 and a
    carrier drawn). Order ``o_id`` sits at slot ``o_id`` and is stamped
    ``o_id``; the order columns' draws come from ``seed`` on the device.
    The stock and order counters start at zero, the rest of the ring
    empty."""
    W, D, C = scale.n_warehouses, scale.districts, scale.customers
    I, OC, L = scale.n_items, scale.order_capacity, scale.max_lines
    N, undelivered = C, C * 3 // 10
    f32, i32 = torch.float32, torch.int32
    if N > OC:
        raise SystemExit(f"portbench: {N} initial orders a district exceed "
                         f"its ring of {OC}")

    def put(a):                      # a copy, never a view of the draws
        return torch.tensor(a, device=dev)

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=dev)

    t = dict(w_ytd=full((W,), 10.0 * C * D, f32), w_tax=put(draws.w_tax),
             d_next_o_id=full((W, D), N, i32),
             d_ytd=full((W, D), 10.0 * C, f32), d_tax=put(draws.d_tax),
             h_amount_sum=full((W, D), 10.0 * C, f32),
             c_balance=full((W, D, C), -10.0, f32),
             c_ytd_payment=full((W, D, C), 10.0, f32),
             c_payment_cnt=full((W, D, C), 1, i32),
             c_delivery_cnt=full((W, D, C), 0, i32),
             c_discount=put(draws.c_discount),
             c_delivered_sum=full((W, D, C), 0.0, f32),
             s_quantity=put(draws.s_quantity), s_ytd=full((W, I), 0.0, f32),
             s_order_cnt=full((W, I), 0, i32),
             s_remote_cnt=full((W, I), 0, i32),
             i_price=put(draws.price).expand(W, I).contiguous())
    for name, fill in ORDER_FILL.items():
        shape = (W, D, OC, L) if name in LINE_COLUMNS else (W, D, OC)
        dt = torch.bool if isinstance(fill, bool) else (
            f32 if isinstance(fill, float) else i32)
        t[name] = full(shape, fill, dt)

    g = _generator(torch, seed, dev)
    o_id = torch.arange(N, dtype=i32, device=dev).expand(W, D, N)
    done = o_id < N - undelivered
    cnt = torch.randint(5, L + 1, (W, D, N), generator=g, device=dev,
                        dtype=i32)
    lv = torch.arange(L, device=dev) < cnt[..., None]
    home = torch.arange(W, dtype=i32, device=dev)[:, None, None, None]
    pop = dict(
        o_valid=True,
        o_c_id=torch.rand((W * D, N), generator=g, device=dev).argsort(1)
        .to(i32).view(W, D, N),
        o_ol_cnt=cnt,
        o_carrier=torch.where(done, torch.randint(
            1, 11, (W, D, N), generator=g, device=dev, dtype=i32), -1),
        o_entry_d=o_id, no_valid=~done, o_ts=o_id, ol_valid=lv,
        ol_i_id=torch.where(lv, torch.randint(
            0, I, (W, D, N, L), generator=g, device=dev, dtype=i32), 0),
        ol_supply_w=torch.where(lv, home, 0),
        ol_qty=torch.where(lv, 5, 0).to(i32),
        ol_amount=torch.where(lv & ~done[..., None], torch.rand(
            (W, D, N, L), generator=g, device=dev) * 9999.98 + 0.01, 0.0),
        ol_delivered=lv & done[..., None],
        ol_ts=torch.where(lv, o_id[..., None], -1), ol_vis=lv)
    for name, v in pop.items():
        t[name][:, :, :N] = v
    return t


def host_tables(tables: dict, slots: int) -> dict:
    """The tables on the host: every column whole but the order tables,
    cut to their first ``slots`` slots."""
    return {k: (x[:, :, :slots] if k in ORDER_FILL else x).cpu().numpy()
            for k, x in tables.items()}


def initial_tables(cfg: dict, traffic: dict, seed: int, device):
    """(the judged stream, the initial tables on the host cut to the slots
    the judged pass can reach): what the reference replays from, as a run
    with this seed makes it on ``device``."""
    import torch

    scale, draws, _, judged = make_inputs(cfg, traffic, seed)
    tables = device_tables(torch, draws, scale, torch.device(device), seed)
    slots = written_slots(tables["d_next_o_id"].cpu().numpy(), judged,
                          scale.order_capacity)
    return judged, host_tables(tables, slots)


def _batches(torch, cls, batches, dev):
    if batches is None:
        return None
    return [cls(*(torch.tensor(b[f], device=dev) for f in cls._fields))
            for b in batches]


def replay(cfg: dict, traffic: dict, initial: dict, stream,
           precision: str = "float32"):
    """The configuration's reference (its ``reference`` key names the
    module under ``portbench/reference/``) over one pass."""
    traffic = traffic_of(traffic)
    mod = importlib.import_module(f"portbench.reference.{cfg['reference']}")
    return mod.replay(initial, stream,
                      order_capacity=cfg["scale"]["order_capacity"],
                      regime=cfg["regime"], hot_items=cfg.get("hot_items"),
                      merge_every=traffic["merge_every"],
                      refresh_every=traffic["refresh_every"],
                      deliveries=traffic["deliveries"], precision=precision,
                      n_shards=cfg["n_shards"])


def read_program(state, esc, snap: dict, slots: int) -> dict:
    """The program's tables after a pass on the host, the order tables cut
    to ``slots``, and the count of entries past them that differ from the
    initial tables (on the device)."""
    tables = dict(state._asdict())
    tail = sum(int((tables[k][:, :, slots:] != snap[k][:, :, slots:]).sum())
               for k in ORDER_FILL)
    out = dict(tables=host_tables(tables, slots), tail=tail)
    if esc is not None:
        out["shares"] = esc.shares.cpu().numpy()
        out["spent"] = esc.spent.cpu().numpy()
    return out


def run(cfg: dict, traffic: dict, *, seed: int, seconds: float, trace: bool,
        device, t0: float):
    """One run of a cell; returns the record the metric readers read."""
    import torch

    from repro_torch.txn import tpcc
    from repro_torch.txn.engine import Engine
    from repro_torch.txn.executor import get_fused_executor, stack_chunks

    traffic = traffic_of(traffic)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    escrow = cfg["regime"] == "escrow"
    marks = {"start": time.perf_counter() - t0}
    scale, draws, stream, judged = make_inputs(cfg, traffic, seed)
    marks["inputs"] = time.perf_counter() - t0
    tables = device_tables(torch, draws, scale, dev, seed)
    snap = {k: v.clone() for k, v in tables.items()}
    state = tpcc.TPCCState(**tables)
    port_scale = tpcc.TPCCScale(**cfg["scale"])
    eng = (Engine(port_scale, stock_invariant="strict",
                  escrow_layout=cfg["escrow_layout"],
                  hot_items=cfg["hot_items"], admission=ADMISSION,
                  effects=EFFECTS, device=dev) if escrow
           else Engine(port_scale, n_shards=cfg["n_shards"], device=dev))
    esc = eng.init_escrow(state) if escrow else None
    esc_snap = (esc.shares.clone(), esc.spent.clone()) if escrow else None

    def stacked(s):
        return stack_chunks(
            _batches(torch, tpcc.NewOrderBatch, s.neworder, dev),
            _batches(torch, tpcc.PaymentBatch, s.payment, dev),
            _batches(torch, tpcc.OrderStatusBatch, s.order_status, dev),
            _batches(torch, tpcc.StockLevelBatch, s.stock_level, dev),
            traffic["merge_every"])

    chunks, judged_chunks = stacked(stream), stacked(judged)
    ex = get_fused_executor(eng, ring_rows=traffic["merge_every"],
                            deliveries=traffic["deliveries"])
    marks["tables"] = time.perf_counter() - t0

    def restore():
        for name, x in zip(state._fields, state):
            x.copy_(snap[name])
        if escrow:
            esc.shares.copy_(esc_snap[0])
            esc.spent.copy_(esc_snap[1])

    def call(chunks_, warmup: bool, hooks):
        """One executor call: (its own wall, counters, cold rejects)."""
        if escrow:
            _, _, counters, wall, _, cold, _ = ex.run_escrow(
                state, esc, chunks_, refresh_every=traffic["refresh_every"],
                warmup=warmup, obs=hooks)
            return wall, counters, cold
        _, counters, wall = ex.run(state, chunks_, warmup=warmup, obs=hooks)
        return wall, counters, 0

    call(chunks, True, None)
    marks["warm"] = time.perf_counter() - t0
    restore()
    # set-up's objects live to the end: out of the collector's way, so a
    # collection in the window walks only what the window makes
    gc.collect()
    gc.freeze()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t0

    rec = SimpleNamespace(setup_s=setup_s, walls=[], program_walls=[],
                          pass_counters=[], windows=[], spans={},
                          instance_passes=0, trace=None, traced_passes=0,
                          kernel_bytes={})
    profiled = int(traffic["trace_passes"]) if trace and cuda else 0

    def session():
        from repro_torch.obs import ObsSession
        return ObsSession(metrics=False, trace=True, sync_spans=False)

    def timed_pass(chunks_, obs, in_profile: bool):
        hooks = _Hooks(torch, obs, len(chunks_), dev)
        with torch.profiler.record_function("portbench.pass"):
            h0 = time.perf_counter()
            wall, counters, cold = call(chunks_, False, hooks)
            rec.walls.append(time.perf_counter() - h0)
        rec.program_walls.append(wall)
        c = {k: int(getattr(counters, k).sum()) for k in counters._fields}
        c["cold_rejects"] = int(cold)
        rec.pass_counters.append(c)
        last = ex.last_run
        n = hooks.i
        rec.windows.extend(zip(last.get("chunk_ms") or [None] * n,
                               last.get("drain_ms") or [None] * n,
                               hooks.window_ms(), hooks.window_commits(),
                               [in_profile] * n))

    # the instance's passes first, with spans when the run traces: the
    # profiler slows the host after it has run
    spans = session() if trace else None
    for _ in range(window_passes(traffic, seconds)):
        restore()
        timed_pass(chunks, spans, False)
    rec.instance_passes = len(rec.walls)
    if spans is not None:
        rec.spans = {k: (p.count, p.total_s)
                     for k, p in spans.tracer.phases.items()}
    # then the judged stream, drawn from the seed, as the window's last
    # pass; a traced run profiles it (its last profiled pass is judged)
    if profiled:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        traced = session()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(profiled):
                restore()
                timed_pass(judged_chunks, traced, True)
        from portbench import tracing
        rec.trace = tracing.summarize(prof)
        rec.traced_passes = profiled
        del prof
    else:
        restore()
        timed_pass(judged_chunks, None, False)
    rec.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev) if cuda
                             else 0)

    t_read = time.perf_counter()
    slots = written_slots(snap["d_next_o_id"].cpu().numpy(), judged,
                          scale.order_capacity)
    program = read_program(state, esc, snap, slots)
    program["counters"] = rec.pass_counters[-1:]
    program["instance_passes"] = rec.pass_counters[:rec.instance_passes]
    initial = host_tables(snap, slots)
    del state, snap, tables, esc, esc_snap, chunks, judged_chunks
    ex.last_run = {}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    per_pass_no = traffic["batch"] * traffic["batches_per_pass"]
    rec.attempted = sum(
        (c["neworders"] + c["aborts"]) + c["payments"] + c["order_statuses"]
        + c["stock_levels"] + c["deliveries"] for c in rec.pass_counters)
    rec.failed = sum(c["aborts"] + c["cold_rejects"]
                     for c in rec.pass_counters)
    rec.diag = dict(
        setup_marks_s=marks, passes=len(rec.walls),
        window_s=sum(rec.walls), program_s=sum(rec.program_walls),
        pass_ms=[round(w * 1e3, 3) for w in rec.walls],
        outside_program_ms=[round((w - p) * 1e3, 3) for w, p
                            in zip(rec.walls, rec.program_walls)],
        read_back_s=time.perf_counter() - t_read,
        abort_share=rec.pass_counters[0]["aborts"] / per_pass_no,
        judged_abort_share=rec.pass_counters[-1]["aborts"] / per_pass_no)
    t_ref = time.perf_counter()
    ref = replay(cfg, traffic, initial, judged)
    del initial
    rec.checks = judge_mod.judge(ref, program, escrow)
    rec.diag["reference_s"] = time.perf_counter() - t_ref
    rec.correct = judge_mod.verdict(rec.checks)
    rec.limits = {k: judge_mod.LIMITS[k] for k in rec.checks}
    rec.reference, rec.program = ref, program

    # the kernels' problems of the judged pass (the profiled passes run
    # its stream), from its batches and the reference's reads
    if escrow:
        tot = np.zeros(2, np.int64)
        for b in judged.neworder:
            tot += kernel_bytes.txn_megastep(b, scale.n_items, 0,
                                             scale.n_warehouses)
        rec.kernel_bytes["txn_megastep"] = tuple(int(x) for x in tot)
    if ref.read_lines:
        tot = np.zeros(2, np.int64)
        for rows, need, match, inv, present in ref.read_lines:
            tot += kernel_bytes.ramp_read(rows, scale.max_lines, need, match,
                                          inv, present)
        rec.kernel_bytes["ramp_read"] = tuple(int(x) for x in tot)
    return rec
