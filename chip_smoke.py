#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card: TPC-C New-Order
alone, the five-transaction mix, the anti-entropy merge of divergent
replica snapshots, LM serving (all six model families), the dense
escrow layout, the coordinated 2PC baseline, TPC-C as four replicas on
one card, their cold-retry ring, crash recovery with self-detecting
liveness, the fused executor (a chunk of batches as one CUDA graph), the
observability plane with the TPC-C serving driver, LM training, and the
dry run that traces every step without memory and holds it to the card.

    python3 chip_smoke.py

From the root of a checkout, on a machine with an NVIDIA H100. It builds the
six CUDA kernels of the port from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per source, started together, into ``build/kernels/``), then:

  1. prints the card and its power limit, and the build time;
  2. holds each kernel bit-exact against its plain torch version on the
     card, on the main path's first real admission problem and on a
     heavily contended one of the same shape, and times both (after the
     main path, also on the problem its next batch would meet, whose
     residual walk has work: those are the times of the kernels' record;
     for escrow_admit and txn_megastep the record adds the time at
     n_res = 0, batch 0's, and the walk's us a residual transaction), and
     prints the walk's block, tile and shared memory and the two walk
     kernels' registers and spills from ``nvcc -Xptxas -v``;
  3. merge regime: the New-Order closed loop, then the audit;
  4. escrow regime through the kernels (sparse hot set, admission="kernel",
     effects="fused": the megastep kernel), then the strict audit; the
     same run with effects="scan" goes through the escrow_admit kernel;
  5. the same escrow run through the plain path on the card (admission and
     effects "scan"), which must end bit-equal to phase 4;
  6. a small run through the kernels on the card against the plain path
     on the CPU, bit-equal: New-Order alone and the five-transaction mix,
     the dense escrow layout through each kernel, and the strict 2PC
     baseline through the escrow_admit kernel;
  7. the mix in the merge regime (New-Order, Payment, Order-Status through
     the ramp_read kernel, Stock-Level, Delivery), then the audit, whose
     twelve criteria now see every money column move;
  8. the mix in the escrow regime through the megastep kernel, then the
     strict audit (txn_megastep and ramp_read on one path);
  9. the ramp_read kernel bit-exact against its plain version on the card,
     and both timed: (a) the main path's Order-Status problem on phase 7's
     final state, as it is and with half the lines concealed (so the
     lookback repairs), and (b) the whole order table as one problem of
     W * D * OC rows, a bandwidth problem;
 10. replica anti-entropy: phase 7's stock table as a ``VersionedSlots``
     (W * 100,000 rows of s_quantity, s_ytd, s_order_cnt, s_remote_cnt in
     float32, int64 stamps), four replicas that each upsert a seeded 5% of
     the rows (replica 2 also plants s_quantity = -1 in a seeded set at the
     highest stamp), then ``merge_many`` and ``converged`` over the four
     and the audited ``merge_versioned_fused`` of replicas 0 and 2, all
     through the lattice_merge kernel; held bit-equal to the plain version
     on the card and the plain path on the CPU, the audit mask equal to the
     planted rows; then the kernel against its plain version on edge
     problems, and both timed on one pairwise merge at full size;
 11. dense serving: ``repro_torch.launch.serve`` serves 16 requests of
     smollm-360m at full width and depth (bf16 activations and KV, random
     weights) in two static batches of 8, each prefilled in one pass whose
     attention is the flash_attention kernel once a layer (64 launches,
     every one on its bf16 tensor-core route, by its count a route);
     then the kernel against its plain version on the main path's first
     prefill problem (layer 0 of batch 1) and on edge problems, and the
     kernel, the plain version, ``scaled_dot_product_attention`` (the
     library yardstick, not used by the port) timed on the main problem;
 12. RWKV serving: the same for rwkv6-3b, whose prefill runs the
     rwkv6_scan kernel once a layer (64 launches), edge problems adding w
     at its clamp, mixed decays and T around the kernel's chunk; no
     library call computes the scan;
 13. both reduced configurations (float32) through ``Server`` with the
     kernels on the card and with the plain path on the CPU, on the same
     weights and seeded prompts: the generated tokens equal, the first
     decode step's logits within 1e-4 (TF32 off); then the same for the
     four families of phase 21, reduced: the tokens equal, every decode
     step's logits within 1e-4, B5 (float32 route) once an encoder layer
     a batch for whisper's encoder and never for the others;
 14. dense escrow (``escrow_layout="dense"``: a share of every one of the
     6.4 M cells) on phase 4's stream, through the megastep kernel and
     through the escrow_admit kernel, bit-equal to each other and to the
     sparse layout with a full hot set (K = 6.4 M), then the strict audit;
     committed txn/s and escrow bytes a device beside phase 4's sparse
     run; both kernels against their plain versions on the dense layout's
     problem after the run;
 15. the coordinated baseline: ``plan_engine(stock_invariant="serial")``
     returns the strict ``TwoPCEngine``, whose closed loop replays phase
     4's stream through the escrow_admit kernel against the global stock,
     then the strict audit; committed txn/s without and with the D-2PC LAN
     commitment latency of ``txn/latency.py`` (a modeled figure) charged
     per conflicting round, and escrow's ratio over it; on one shard it
     must end bit-equal to phase 14's dense run. The non-strict
     ``TwoPCEngine`` over phase 3's stream ends in phase 3's state, and
     its ``read_step`` on phase 7's final state equals
     ``Engine.order_status_step`` (through the ramp_read kernel);
 16. replicas on one card: the deployment as ``SHARDS`` = 4 shards of 16
     warehouses (``Engine(n_shards=4)``), 64 New-Orders a shard a batch
     (256 a batch, as above), the traffic of phases 3-8: merge New-Order
     and the merge mix (audits, no fracture, ramp_read once a shard a
     batch), sparse escrow through txn_megastep and through escrow_admit
     (a launch a shard a batch) and dense escrow through txn_megastep,
     each strictly audited with the shares of all four replicas, and each
     layout through the plain path on the card (the definitional
     sequential walk), every kernel run bit-equal to its layout's plain
     run; then on each shard's own problem for the next batch (its view,
     ``w_lo``, its replica's headroom and stamps, 64 rows) escrow_admit and
     txn_megastep against their plain versions, in both layouts, and
     timed; strict 2PC on the same per-shard stream (escrow_admit once
     a batch), its throughput without and with the modeled latency, and
     escrow's ratio over it; the 2PC ``read_step`` against
     ``order_status_step``, its grant and vote counted, and each shard's
     Order-Status problem from that batch (as it is and with half the
     lines concealed) through ramp_read against its plain version; the
     structural
     proofs (the hot paths and the RAMP reads call no collective and leave
     the other shards' slices bit-unchanged; anti-entropy, the refreshes
     and both 2PC paths call collectives, by ``txn/collectives.py``'s
     counts); and a small four-shard run through the kernels on the card,
     bit-equal to the plain path on the CPU;
 17. the cold-retry ring on the four replicas: phase 16's deployment under
     the reference's failure-row traffic (half the lines remote, Zipf 1.2),
     the specification's initial stock and one hot item a warehouse, where
     cold cells contend across replicas (at phase 16's traffic the cold
     tier rejects nothing, so the ring would idle); through txn_megastep
     with no ring, ``retry_max`` 0 and 3, reservations, no final flush and
     a dead replica, each held to the JAX package's counts, ring lanes and
     reserved lanes and strictly audited; ``retry_max=0`` bit-equal to no
     ring; ``retry_max=3`` through escrow_admit, the plain path on the card
     and the plain path on the CPU, bit-equal to txn_megastep; a run cut in
     two and resumed through ``retry=``, card against CPU; one ring drain
     under the card's host-sync check; txn/s in turns and the device time
     of one ring drain beside one plain drain;
 18. crash recovery and liveness on phase 17's deployment: (a) its
     16-batch split saved with ``txn.recovery.save_run``, restored with
     ``restore_run(engine)`` bit-equal to the image, and resumed, through
     txn_megastep and through escrow_admit, each ending bit-equal to
     phase 17's in-memory resume; a save that dies before its commit
     leaves ``latest_manifest`` on the committed generation; the bytes,
     save and restore seconds and GB/s (time to recover); (b)
     ``run_loop(liveness=LeaseMonitor)``: a monitor beating every replica
     bit-equal to ``alive=None``, one whose source stops replica 2's
     beats held to the JAX package's counts and detection lags; (c) the
     reference's two failure rows (a kill, a checkpoint and a recovery; a
     self-detected kill and a revival) through ``EscrowPodSimulator`` at
     full width, held to the JAX package's counts, with exact cold
     ledgers, strict audits, committed txn/s and the recover call's
     seconds, each serving replica's step one txn_megastep launch; (d)
     the same rows at the reference's toy scale, held to the committed
     ``BENCH_escrow_failures.json`` and ``BENCH_liveness.json``;
 19. the fused executor (``run_loop(fused=True)``, the default; phases 1-18
     pin ``fused=False``): on phase 4's deployment and on phase 16's four
     shards, merge New-Order, the merge mix, escrow New-Order through
     txn_megastep and through escrow_admit, and the escrow mix, each chunk
     of ``MERGE_EVERY`` batches one CUDA graph replay; three fused and three
     dispatch runs in turns, all bit-equal (state, escrow, counts), the
     first audited; B1, B2 and B3 launches a run equal to dispatch's,
     counted through the replays; txn/s both ways with the spread; the
     device time of one chunk replay and one drain (CUDA events in the run,
     and queued behind a spin) and the graph's pool bytes; then phase 17's
     ``retry_max=3`` run and phase 18 (b)'s stop-beat run through
     ``fused=True``, held to the JAX package's counts;
 20. the observability plane (``run_loop(obs=ObsSession(...))``): phase
     19's merge mix and escrow mix (txn_megastep) rows on phase 4's and
     phase 16's deployments, three runs with metrics and three without in
     turns, all bit-equal, B1-B3 launches equal, in the merge regime each
     graph's captured launches and pool bytes equal; txn/s both ways and
     ``metrics_on_vs_off``; one run with the ledger and device-synced
     spans, its snapshot held to the JAX package's (``OBS_REFERENCE``:
     latency counts and steps, counters, item demand, lattice digests,
     ledger with no hot collective) and its span shares beside the
     executor's CUDA-event chunk and drain times; then
     ``python -m repro_torch.launch.tpcc_serve --batches 8`` on the card;
 21. the moe, hybrid, vlm and audio families: ``repro_torch.launch.serve``
     serves 16 requests of olmoe-1b-7b, hymba-1.5b, llama-3.2-vision-11b
     and whisper-tiny at full width and depth (bf16, random weights, one
     model on the card at a time), prompts of 2-128 tokens teacher-forced
     one decode step a token as the reference does, 32 new tokens; B5's
     launches: 8 for whisper (its encoder, 4 layers x 2 batches, on the
     tensor-core route), none for the others; then olmoe's
     ``registry.make_prefill_fn`` on batch 1's prefix (16 launches); B5
     against its plain version and timed, beside SDPA and its bound, on
     the two problems these paths give it: (a) olmoe's prefill, hd 128,
     causal, (b) whisper's encoder, S 1500, non-causal; the hd-128
     tensor-core kernel's registers and spills; per model its parameters,
     ``max_memory_allocated``, tok/s, prefill and decode ms;
 22. training (``repro_torch.runtime.train.run``, ``optim.coord.build``,
     ``runtime.failures.PodSimulator``), which launches none of the six
     kernels (their counts must not move): (a) each of the six families
     reduced, in float32 and in bf16 on float32 masters, one sync step on
     the card against the same step on the CPU from the same parameters
     and batch, the loss, the gradients and the update within
     ``TRAIN_TOL`` (``TRAIN_TOL_BF16`` in bf16); (b) smollm-360m at full
     width, sync, 20 pipeline steps of 8 x 512 tokens, remat, bf16 on
     float32 masters, AdamW with escrow clipping: tokens/s, peak memory,
     the loss finite; then 12 steps on one fixed batch, each timed by
     CUDA events, whose loss must fall; (c) 2 pods, hierarchical, the int8 merge every
     4 of 12 steps: the pods apart before each merge and equal after it,
     each merge's device ms and counted bytes; (d) under deterministic
     algorithms, a checkpoint at step 10 and a restart to 20 equal to an
     uninterrupted 20-step run bit for bit, with the save's and the
     restore's seconds; (e) ``PodSimulator`` on 2 pods, reduced: a kill, a
     survivor's step, the recovery, a merge: valid, divergence 0, each
     token counted once;
 23. the dry run (``repro_torch.launch.dryrun``): (a) phase 22's step
     traced on meta tensors, then run once on the card under
     ``FlopCounterMode`` and the dry run's op counter: FLOPs and the ops
     kind by kind equal, the traced peak within ``DRY_PEAK_TOL`` of
     ``max_memory_allocated`` less what earlier phases still hold; (b) the same for a prefill batch of
     smollm-360m through B5 and of rwkv6-3b through B6, the kernels'
     counted operations equal to their shape-only routes', and the ops
     of the ``Server``'s decode step; (c) ``--arch tpcc`` at its defaults
     (512 spec-scale warehouses on 4 shards, the audit run on the card);
     (d) ``DRY_CELLS`` on 1 and 2 pods, the sweep's host time; (e) a line
     a cell: fits, GB a card, TFLOP and ops a step.

The deployment is TPC-C at the specification's per-warehouse cardinalities
(TPC-C standard specification, clause 4.3.3.1: 10 districts, 3000 customers
per district, 100,000 items, up to 15 lines per order) with the repo's ring
of 8192 orders per district, 64 warehouses on the card as one shard. The
traffic is batches of 256 New-Orders with 1% remote lines (spec), 32
batches, an anti-entropy drain every 8 batches and an escrow refresh at
every drain; the mix adds per batch 256 Payments, 64 Order-Status and 64
Stock-Level queries (``read_frac`` 0.25) and one Delivery per district.
The serving deployments are smollm-360m (HF HuggingFaceTB/SmolLM-360M)
and rwkv6-3b (arXiv:2404.05892) at their published widths and depths, with
the launcher's seeded prompts of 2-512 tokens, 32 new tokens each and
SmolLM's context of 2048 as the KV capacity; phase 21's are olmoe-1b-7b
(arXiv:2409.02060), hymba-1.5b (arXiv:2411.13676), llama-3.2-vision-11b
(HF meta-llama/Llama-3.2-11B-Vision) and whisper-tiny (arXiv:2212.04356,
its text context of 448 as the KV capacity).

Launch counters are set to 0 just before each main path (phases 3-4, 7,
8, 10, 11, 12, 14, 15, each run of 16, 17, 18, 19 and 20, and each model
and the prefill of 21, and 23) and read just after; phase 22 launches no
kernel, so the counts read before and after it must be equal. The second-to-last line of output is the kernels' JSON record;
the last line is the device record. Any failure exits non-zero; so does
a machine without a CUDA device.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

WAREHOUSES = 64
BATCH = 256
N_BATCHES = 32
MERGE_EVERY = 8
REFRESH_EVERY = 1
REMOTE_FRAC = 0.01
ITEM_SKEW = 1.2          # the escrow demo's Zipfian item profile
STOCK_MULTIPLIER = 20    # the escrow demo's inflated initial stock
SEED = 0
READ_FRAC = 0.25         # Order-Status and Stock-Level queries per New-Order
MIX = dict(payments=True, reads=True, deliveries=True, read_frac=READ_FRAC)
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
# dense peak operation rates of one H100 SXM (NVIDIA data sheet): bf16 on
# the tensor cores, float32 outside them
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
SPIN_CYCLES = 100_000_000   # ~50 ms at the H100's 1.98 GHz boost clock


def _time_ms(fn, reps: int, fresh=None) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events
    around each call. A spin on the card runs first, long enough for the
    host to queue every call behind it, so a call that does not
    synchronise is timed by the card's work alone, not by the host's
    launch overhead. With ``fresh = (buf, src)``, ``buf`` is refilled from
    ``src`` before each call, outside the timed interval (a kernel that
    updates its ``avail0`` in place gets a fresh vector, as on the main
    path)."""
    import torch

    def call():
        if fresh is not None:
            fresh[0].copy_(fresh[1])
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        fn()
        ev[1].record()
        return ev

    call()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    events = [call() for _ in range(reps)]
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / reps


def _max_abs_err(got, want) -> float:
    err = 0.0
    for x, y in zip(got, want):
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"dtype/shape mismatch {x.dtype} {y.dtype}")
        d = (x.double() - y.double()).abs()
        err = max(err, float(d.max()) if d.numel() else 0.0)
    return err


def _nbytes(*xs) -> int:
    return sum(x.numel() * x.element_size() for x in xs)


def _same(a, b) -> list[str]:
    import torch
    return [f for f, x, y in zip(a._fields, a, b) if not torch.equal(x, y)]


def admission_problem(eng, state, esc, batch, r=0):
    """The megastep problem ``(args, kw)`` that shard ``r`` of the escrow
    main path builds for its part of ``batch`` against ``state`` and
    ``esc``, in ``eng``'s layout, as the engine builds it: the shard's
    view, ``w_lo``, its replica's headroom ``shares[r] - spent[r]`` and
    stamps (its first four arguments are the admission problem)."""
    from repro_torch.txn import tpcc
    from repro_torch.txn.engine import batch_parts

    n_items, R = eng.scale.n_items, eng.n_shards
    w_lo = r * eng.w_per_shard
    view = eng.shard_view(state, r)
    part = batch_parts(batch, R)[r]
    if eng.escrow_layout == "sparse":
        avail0, slot = tpcc.sparse_admission_problem(
            view.s_quantity, esc.keys, esc.shares[r] - esc.spent[r],
            part.supply_w, part.i_id, n_items, w_lo, w_lo + eng.w_per_shard)
    else:
        avail0 = (esc.shares[r] - esc.spent[r]).reshape(-1)
        slot = part.supply_w * n_items + part.i_id
    return tpcc.megastep_args(view, part, eng.scale, avail0, slot,
                              tpcc.order_line_valid(part),
                              part.ts * R + r, w_lo, w_lo + eng.w_per_shard)


def main_path_batch(eng, index, batch_per_shard=BATCH):
    """Batch ``index`` of the escrow main path's stream (same seed)."""
    import numpy as np

    from repro_torch.txn.drivers import generate_neworder_stream

    return generate_neworder_stream(
        eng, batch_per_shard=batch_per_shard, n_batches=index + 1,
        remote_frac=REMOTE_FRAC, rng=np.random.default_rng(SEED),
        item_skew=ITEM_SKEW)[index]


def check_and_time(tag, args, kw, oracle=False):
    """Each kernel against its plain version on the card on one problem
    (and, with ``oracle``, the megastep against the definitional oracle
    too), then both timed with CUDA events, and each kernel's bound from
    the bytes this problem makes it move. Returns the row per kernel."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.escrow_admit import (
        WALK_THREADS, contention_gate, escrow_admit_cuda, residual_fcfs,
        residual_order, walk_shape)
    from repro_torch.kernels.txn_megastep import (
        MegastepOut, txn_megastep_cuda, txn_megastep_plain)

    avail0, slot, qty, lv = args[:4]
    fast, _, _ = contention_gate(*args[:4])
    res_idx, n_res = residual_order(fast)
    gate = (fast, res_idx, n_res)
    n = int(n_res[0])
    # the kernels update avail in place: each call gets a fresh copy
    buf = avail0.clone()
    admit = lambda: escrow_admit_cuda(buf, slot, qty, lv, *gate)
    mega = lambda: txn_megastep_cuda(buf, slot, qty, lv, *gate, *args[4:],
                                     **kw)
    got_a = tuple(x.clone() for x in admit())
    buf.copy_(avail0)
    got_m = MegastepOut(*(x.clone() for x in mega()))
    err_a = _max_abs_err(got_a, residual_fcfs(*args[:4], *gate))
    err_m = _max_abs_err(got_m, txn_megastep_plain(*args[:4], *gate,
                                                   *args[4:], **kw))
    if oracle:
        err_m = max(err_m, _max_abs_err(
            got_m, MegastepOut(*ref.txn_megastep_ref(*args, **kw))))
    T, H, smem = walk_shape(*slot.shape)
    print(f"parity [{tag}] n_res={n} aborts={int((~got_m.committed).sum())}"
          f" escrow_admit max_abs_err={err_a} txn_megastep "
          f"max_abs_err={err_m}; walk: a block of {WALK_THREADS} threads, "
          f"B={slot.shape[0]} L={slot.shape[1]}, tiles of T={T} "
          f"transactions ({-(-n // T)} walked), H={H} table entries, "
          f"{smem} bytes of dynamic shared memory")
    if err_a or err_m:
        raise AssertionError(f"kernel disagrees with plain version: {tag}")

    # least bytes, each input read once and each output written once; the
    # avail vector is updated in place, so only the cells the lines name
    # count (4 bytes read, 4 written each)
    res = torch.zeros_like(fast)
    res[res_idx[:n].long()] = True
    res_lines = lv & res[:, None]
    cells = lambda m: 8 * int(torch.unique(slot[m]).numel())
    # escrow_admit: the residual lines (slot, qty, valid), their indices and
    # count, the fast mask in and the verdicts out
    bytes_a = cells(res_lines) + slot.shape[1] * n * 9 + n * 4 + 4 \
        + _nbytes(fast) + _nbytes(got_a[0])
    # txn_megastep: the whole window (of res_idx only the first n) and every
    # product but avail, the dense slabs included
    out_bytes = sum(_nbytes(x) for f, x in zip(got_m._fields, got_m)
                    if f != "avail")
    bytes_m = cells(lv) + _nbytes(*args[1:], *gate) - 4 * (len(fast) - n) \
        + out_bytes
    row = dict(
        escrow_admit=dict(
            max_abs_err=err_a, n_res=n,
            ms=_time_ms(admit, 50, (buf, avail0)),
            plain_ms=_time_ms(lambda: residual_fcfs(*args[:4], *gate), 3),
            bound_ms=bytes_a / HBM_BYTES_PER_S * 1e3),
        txn_megastep=dict(
            max_abs_err=err_m, n_res=n,
            ms=_time_ms(mega, 50, (buf, avail0)),
            # of which the wrapper's one fill of d_count and the dense slabs
            fill_ms=_time_ms(lambda: torch.zeros(
                (kw["n_keys"] + 3 * kw["n_cells"],), dtype=torch.int32,
                device=avail0.device), 50),
            plain_ms=_time_ms(lambda: txn_megastep_plain(
                *args[:4], *gate, *args[4:], **kw), 3),
            bound_ms=bytes_m / HBM_BYTES_PER_S * 1e3))
    print(f"timing [{tag}] {json.dumps(row)}")
    return row


def kernel_parity(eng, state, esc):
    """Phase 2: the main path's first admission problem, and a contended
    one of its shape (hot headroom 0..11), checked against the plain
    versions; returns the two rows of ``check_and_time``."""
    import torch

    args, kw = admission_problem(eng, state, esc, main_path_batch(eng, 0))
    K = esc.keys.shape[0]
    contended = args[0].clone()
    contended[:K] = torch.remainder(torch.arange(K, device=contended.device),
                                    12).to(torch.int32)
    first = check_and_time("main path batch 0", args, kw)
    hard = check_and_time("contended", (contended,) + args[1:], kw,
                          oracle=True)
    return first, hard


def walk_costs(timing, first, hard):
    """Add to B1's and B2's record rows the time at ``n_res`` = 0 (the main
    path's batch 0) and the walk's cost a residual transaction, ``(ms at
    n_res > 0 - ms at n_res = 0) x 1000 / n_res`` in us, on the timed
    problem; print it for the contended problem too."""
    if first["escrow_admit"]["n_res"] != 0:
        raise AssertionError("the main path's batch 0 has residual work")
    slope = lambda row, k: (row[k]["ms"] - first[k]["ms"]) * 1e3 \
        / row[k]["n_res"]
    for k in ("escrow_admit", "txn_megastep"):
        timing[k]["ms_n_res_0"] = first[k]["ms"]
        timing[k]["us_per_residual"] = slope(timing, k)
        print(f"walk cost [{k}]: {first[k]['ms']} ms at n_res=0; "
              f"{slope(timing, k)} us a residual transaction after the run "
              f"(n_res={timing[k]['n_res']}), {slope(hard, k)} contended "
              f"(n_res={hard[k]['n_res']})")


def escrow_run(scale, admission, effects, device=None, batch=BATCH,
               n_batches=N_BATCHES, audit=True, mix=None, fused=False,
               **engine_kw):
    """The escrow main path (``mix``: the run_loop knobs of the
    five-transaction mix; ``engine_kw``: the layout's, ``escrow_layout``
    and ``hot_items``), by dispatch unless ``fused``. Returns (state,
    escrow, stats, audit report, with the escrow-coverage check it
    ran)."""
    from repro_torch.txn import assert_audit, init_state, run_loop
    from repro_torch.txn.engine import single_host_engine

    eng = single_host_engine(scale, stock_invariant="strict",
                             admission=admission, effects=effects,
                             device=device, **engine_kw)
    state = init_state(scale, seed=SEED, device=eng.device)
    state.s_quantity.mul_(STOCK_MULTIPLIER)
    q0 = state.s_quantity.clone()
    state, esc, st = run_loop(
        eng, state, batch_per_shard=batch, n_batches=n_batches,
        remote_frac=REMOTE_FRAC, merge_every=MERGE_EVERY,
        refresh_every=REFRESH_EVERY, item_skew=ITEM_SKEW, seed=SEED,
        fused=fused, **(mix or {}))
    rep = ""
    if audit:
        t0 = time.perf_counter()
        rep = assert_audit(state, escrow=esc, initial_stock=q0,
                           strict_stock=True)
        covers = [k for k in rep.checks if k.startswith("escrow_covers")]
        rep = (f"{rep.describe()} ({', '.join(covers)}) in "
               f"{time.perf_counter() - t0:.1f} s")
    return state, esc, st, rep


def ramp_read_bytes(args, got) -> tuple[int, int]:
    """The bytes the fused read must move on this problem: the metadata of
    every row; the stamp of each needed line, its visibility where the
    stamp matches, its prepared bit where a matching line is invisible,
    its amount and item id where it is present; every output once. Returns
    (those bytes, the bytes of every input and output once)."""
    import torch

    req_ts, nlines, ol_ts, ol_vis = args[:4]
    line = torch.arange(ol_ts.shape[1], device=ol_ts.device)
    need = line[None, :] < nlines[:, None]
    match = need & (ol_ts == req_ts[:, None])
    lines = (4 * int(need.sum()) + int(match.sum())
             + int((match & ~ol_vis).sum()) + 8 * int(got[0].sum()))
    return (_nbytes(req_ts, nlines) + lines + _nbytes(*got),
            _nbytes(*args, *got))


def ramp_read_check_and_time(tag, args, reps):
    """The ramp_read kernel against its plain version on the card on one
    problem, bit for bit, then both timed, and the bound from the bytes
    this problem's data makes it move (:func:`ramp_read_bytes`). Returns
    the row."""
    from repro_torch.kernels.ramp_read import ramp_read_cuda, ramp_read_plain

    got = ramp_read_cuda(*args)
    err = _max_abs_err(got, ramp_read_plain(*args))
    R = args[0].shape[0]
    repaired = int(got[5].sum())
    print(f"parity [ramp_read, {tag}] rows={R} lines_read="
          f"{int(got[4].sum())} repaired={repaired} max_abs_err={err}")
    if err:
        raise AssertionError(f"ramp_read disagrees with plain: {tag}")
    need_bytes, all_bytes = ramp_read_bytes(args, got)
    row = dict(max_abs_err=err, rows=R, repaired=repaired,
               bytes=need_bytes, bytes_all_streams=all_bytes,
               ms=_time_ms(lambda: ramp_read_cuda(*args), reps),
               plain_ms=_time_ms(lambda: ramp_read_plain(*args), 3))
    row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
    print(f"timing [ramp_read, {tag}] {json.dumps(row)}")
    return row


def ramp_read_problems(eng, state):
    """Phase 9. Problem (a): the main path's first Order-Status batch on
    ``state``, gathered as ``apply_order_status`` gathers it; then the same
    queries, each asking for the customer of its district's latest order
    (the stream's customers mostly have none: 3000 a district), on a copy
    with half the lines concealed, so that the lookback repairs. Problem
    (b): the whole order table of that copy as ``[W * D * OC, L]``
    zero-copy views. Returns the three rows."""
    import torch

    from repro_torch.txn import ramp
    from repro_torch.txn.drivers import generate_mix_batches

    os_batch = generate_mix_batches(
        eng, batch_per_shard=BATCH, n_batches=1, remote_frac=REMOTE_FRAC,
        read_frac=READ_FRAC, seed=SEED)[2][0]
    wl, d = os_batch.w.long(), os_batch.d.long()
    OC = state.o_c_id.shape[-1]
    latest = ((state.d_next_o_id[wl, d] - 1) % OC).long()
    owners = os_batch._replace(c=state.o_c_id[wl, d, latest])
    gen = torch.Generator(device=state.ol_vis.device).manual_seed(SEED)
    hidden = ramp.conceal_lines(state, torch.rand(
        state.ol_vis.shape, generator=gen, device=state.ol_vis.device) < 0.5)
    rows = []
    for tag, st, batch in (("a: main path", state, os_batch),
                           ("a: latest orders' customers, half concealed",
                            hidden, owners)):
        slot, found = ramp.order_status_slots(st, batch)
        rows.append(ramp_read_check_and_time(tag, ramp.order_status_lines(
            st, batch, slot, found), 200))
    L = state.ol_ts.shape[-1]
    whole = (hidden.o_ts.view(-1),
             torch.where(hidden.o_valid, hidden.o_ol_cnt, 0).view(-1),
             hidden.ol_ts.view(-1, L), hidden.ol_vis.view(-1, L),
             hidden.ol_valid.view(-1, L), hidden.ol_amount.view(-1, L),
             hidden.ol_i_id.view(-1, L))
    rows.append(ramp_read_check_and_time("b: whole order table", whole, 20))
    if rows[1]["repaired"] <= 0 or rows[2]["repaired"] <= 0:
        raise AssertionError("the concealed problems repaired no line")
    return rows


REPLICAS = 4             # divergent replica snapshots merged after a partition
UPSERT_FRAC = 0.05       # rows each replica rewrote while partitioned
PLANTED = 1000           # rows replica 2 drives below the floor
STOCK_COLUMNS = ("s_quantity", "s_ytd", "s_order_cnt", "s_remote_cnt")


def stock_slots(state):
    """The stock table of ``state`` as one ``VersionedSlots``: a row per
    (warehouse, item), the four stock columns as float32 (exact: every value
    is an integer below 2**24), every row valid at stamp
    ``namespaced_version(0, 0, REPLICAS)``."""
    import torch

    from repro_torch.core.lattice import VersionedSlots
    from repro_torch.txn.store import namespaced_version

    payload = torch.stack([getattr(state, c).reshape(-1).float()
                           for c in STOCK_COLUMNS], 1).contiguous()
    R = payload.shape[0]
    stamp = int(namespaced_version(0, 0, REPLICAS))
    return VersionedSlots(
        torch.ones(R, dtype=torch.bool, device=payload.device),
        torch.full((R,), stamp, dtype=torch.int64, device=payload.device),
        payload)


def diverge(base, seed):
    """``REPLICAS`` copies of ``base``; replica r rewrites a seeded
    ``UPSERT_FRAC`` of the rows as one New-Order line each (TPC-C clause
    2.4.2.2: quantity 1-10, restock by 91 below 10, s_ytd += quantity, one
    more order, 1% remote) at stamps ``namespaced_version(k, r, REPLICAS)``
    with k drawn from 1-8 per row, so overlapping rows are settled by the
    stamps. Replica 2 then plants s_quantity = -1 into ``PLANTED`` seeded
    rows at the highest stamp (k = 9). Returns (replicas, planted mask)."""
    import numpy as np
    import torch

    from repro_torch.core.lattice import VersionedSlots
    from repro_torch.txn.store import namespaced_version

    rng = np.random.default_rng(seed)
    R = base.valid.shape[0]
    dev = base.payload.device
    reps = []
    for r in range(REPLICAS):
        idx = torch.from_numpy(rng.choice(R, int(R * UPSERT_FRAC),
                                          replace=False)).to(dev)
        n = idx.numel()
        k = torch.from_numpy(rng.integers(1, 9, n))
        qty = torch.from_numpy(rng.integers(1, 11, n)).to(dev, torch.float32)
        remote = torch.from_numpy(rng.random(n) < REMOTE_FRAC).to(dev)
        old = base.payload[idx]
        left = old[:, 0] - qty
        new = torch.stack([torch.where(left >= 10, left, left + 91),
                           old[:, 1] + qty, old[:, 2] + 1,
                           old[:, 3] + remote.float()], 1)
        rep = VersionedSlots(*(x.clone() for x in base))
        rep.version[idx] = namespaced_version(k, r, REPLICAS).to(dev)
        rep.payload[idx] = new
        reps.append(rep)
    idx = torch.from_numpy(rng.choice(R, PLANTED, replace=False)).to(dev)
    reps[2].payload[idx, 0] = -1.0
    reps[2].version[idx] = int(namespaced_version(9, 2, REPLICAS))
    planted = torch.zeros(R, dtype=torch.bool, device=dev)
    planted[idx] = True
    return reps, planted


def merge_edge_problems(device):
    """Small B4 problems that the full-size one does not exercise: one row;
    257 rows (a 256-thread block does not divide them); one column (the
    element path); a bfloat16 payload of 0.1 against ``hi=0.1``; int32
    stamps; stamps above 2**31 with ties. Returns [(tag, args, lo, hi)]."""
    import numpy as np
    import torch

    rng = np.random.default_rng(SEED)

    def problem(R, W, pay=torch.float32, ver=torch.int64, base=-1):
        out = []
        for _ in range(2):
            p = rng.normal(0, 1, (R, W)).astype(np.float32)
            p[rng.random((R, W)) < 0.25] = 0.1
            out += [torch.from_numpy(rng.random(R) < 0.7),
                    torch.from_numpy(rng.integers(base, base + 40, R)).to(ver),
                    torch.from_numpy(p).to(pay)]
        out[4][: R // 3] = out[1][: R // 3]          # tied stamps: a wins
        return tuple(x.to(device) for x in out)

    return [("R=1", problem(1, 4), -1.0, 1.0),
            ("R=257", problem(257, 4), -1.0, 1.0),
            ("W=1", problem(4096, 1), -1.0, 1.0),
            ("bf16, hi=0.1", problem(1000, 8, pay=torch.bfloat16), -1.0,
             0.1),
            ("int32 stamps", problem(1000, 4, ver=torch.int32), -1.0, 1.0),
            ("stamps above 2**31", problem(1000, 4, base=2**31 - 20), -1.0,
             1.0)]


def lattice_merge_bytes(args, out) -> tuple[int, int]:
    """The bytes one merge must move: both valid masks and both stamps,
    the winning side's payload row (the losing row decides nothing), and
    every output once. Returns (those bytes, the bytes of every input and
    output once)."""
    a_valid, a_ver, a_pay, b_valid, b_ver, b_pay = args
    return (_nbytes(a_valid, a_ver, b_valid, b_ver, a_pay) + _nbytes(*out),
            _nbytes(*args, *out))


def anti_entropy(state):
    """Phase 10 on phase 7's final ``state``; returns the kernel's row."""
    import torch

    from repro_torch.core.lattice import VersionedSlots
    from repro_torch.core.merge import (converged, merge_many,
                                        merge_versioned_fused)
    from repro_torch.kernels.lattice_merge import (lattice_merge_cuda,
                                                   lattice_merge_plain)

    base = stock_slots(state)
    reps, planted = diverge(base, SEED)
    R, W = base.payload.shape
    print(f"anti-entropy: {REPLICAS} replicas of {R:,} rows x {W} float32 "
          f"columns, {_nbytes(*base) / 1e6:.1f} MB a replica, "
          f"{int(UPSERT_FRAC * R):,} rows rewritten by each, {PLANTED} "
          f"planted")
    names = ("versioned",)
    trees = [{"stock": s} for s in reps]

    # the main path: launch counts from 0
    lattice_merge_cuda.launches = 0
    t0 = time.perf_counter()
    merged = merge_many(names, trees)["stock"]
    agree = converged(names, trees)
    audited, viol = merge_versioned_fused(reps[0], reps[2], lo=0.0,
                                          hi=2.0**24)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = lattice_merge_cuda.launches

    def plain(a, b, lo=float("-inf"), hi=float("inf")):
        return lattice_merge_plain(*a, *b, lo, hi)

    p01 = VersionedSlots(*plain(reps[0], reps[1])[:3])
    p23 = VersionedSlots(*plain(reps[2], reps[3])[:3])
    on_card = VersionedSlots(*plain(p01, p23)[:3])
    on_cpu = merge_many(names, [{"stock": VersionedSlots(
        *(x.cpu() for x in s))} for s in reps])["stock"]
    want_audit = plain(reps[0], reps[2], 0.0, 2.0**24)
    bad = [f for f, x, y, z in zip(VersionedSlots._fields, merged, on_card,
                                   on_cpu)
           if not (torch.equal(x, y) and torch.equal(x.cpu(), z))]
    bad += [f"audit {i}" for i, (x, y) in enumerate(zip(
        (*audited, viol), want_audit)) if not torch.equal(x, y)]
    won = int((merged.version > base.version).sum())
    print(f"anti-entropy: merge_many + converged + audited merge in "
          f"{wall:.3f} s, lattice_merge launches={launches}; {won:,} rows "
          f"took a replica's write; converged={agree}; audit flagged "
          f"{int(viol.sum())} rows (planted {PLANTED}); kernel == plain "
          f"on the card == plain on the CPU: {not bad}")
    if bad or not agree or launches < 3:
        raise AssertionError(f"anti-entropy failed: differs {bad}, "
                             f"converged={agree}, launches={launches}")
    if not torch.equal(viol, planted):
        raise AssertionError("the audit mask is not the planted rows")
    if int(merged.payload[:, 0].min()) != -1 or won <= 0:
        raise AssertionError("the merge lost the replicas' writes")

    # B4 against its plain version on the edge problems, bit for bit
    err = 0.0
    for tag, args, lo, hi in merge_edge_problems(base.payload.device):
        got = lattice_merge_cuda(*args, lo, hi)
        want = lattice_merge_plain(*args, lo, hi)
        e = _max_abs_err(got, want)
        same = all(torch.equal(x, y) for x, y in zip(got, want))
        print(f"parity [lattice_merge, {tag}] rows={args[0].numel()} "
              f"flagged={int(got[3].sum())} max_abs_err={e} equal={same}")
        if e or not same:
            raise AssertionError(f"lattice_merge disagrees with plain: {tag}")
        err = max(err, e)

    # one pairwise merge at full size, timed
    args = (*reps[0], *reps[2])
    got = lattice_merge_cuda(*args, 0.0, 2.0**24)
    err = max(err, _max_abs_err(got, want_audit))
    need, every = lattice_merge_bytes(args, got)
    row = dict(max_abs_err=err, rows=R, bytes=need, bytes_both_payloads=every,
               launches=launches,
               ms=_time_ms(lambda: lattice_merge_cuda(*args, 0.0, 2.0**24),
                           50),
               plain_ms=_time_ms(lambda: lattice_merge_plain(
                   *args, 0.0, 2.0**24), 5))
    row["bound_ms"] = need / HBM_BYTES_PER_S * 1e3
    print(f"timing [lattice_merge, pairwise at full size] {json.dumps(row)}")
    return row

SERVE_REQUESTS = 16
SERVE_BATCH = 8
NEW_TOKENS = 32
SERVE_FLAGS = ["--requests", str(SERVE_REQUESTS), "--batch", str(SERVE_BATCH),
               "--prompt-len", "512", "--new-tokens", str(NEW_TOKENS),
               "--capacity", "2048"]   # SmolLM's context length
# the reference's tolerances (tests/test_kernels.py), (rtol, atol): on the
# attention output; on the scan's output and on its final state
ATTN_TOL = {"bfloat16": (2e-2, 2e-2), "float32": (2e-5, 2e-5)}
SCAN_TOL = {"bfloat16": ((2e-2, 2e-2), (5e-2, 5e-2)),
            "float32": ((1e-3, 5e-4), (2e-4, 2e-4))}


def _within(got, want, tol) -> bool:
    """``|got - want| <= atol + rtol * |want|`` everywhere, in float32."""
    rtol, atol = tol
    got, want = got.float(), want.float()
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def _bound(nbytes: int, ops: float, dtype: str) -> tuple[float, str]:
    """The least time (ms) for the bytes over the HBM rate and the
    operations over the peak rate of their type, and which bounds."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def serve_main_path(arch, kernel):
    """Phases 11-12: the launcher at full size, the kernel's launch count
    from 0; checks what it served. Returns (launcher result, launches)."""
    import torch

    from repro_torch.launch import serve as launch

    routes = getattr(kernel, "route_launches", {})   # B5: a count a route
    for key in routes:
        routes[key] = 0
    kernel.launches = 0
    out = launch.run(["--arch", arch, *SERVE_FLAGS])
    torch.cuda.synchronize()
    launches = kernel.launches
    srv = out["server"]
    cfg = srv.model_cfg
    gen = [t for r in out["requests"] for t in r.generated]
    steps = sum(t.steps for t in srv.timings)
    print(f"serving [{arch}]: {out['served']} requests, {out['tok_s']:.1f} "
          f"tok/s; prefill ms per batch "
          f"{[round(t.prefill_s * 1e3, 3) for t in srv.timings]} at prefixes "
          f"{[t.prefix for t in srv.timings]}; decode "
          f"{sum(t.decode_s for t in srv.timings) * 1e3 / steps:.3f} ms a "
          f"token; {kernel.__name__} launches={launches}"
          f"{f' {routes}' if routes else ''}; bookkeeping "
          f"{out['report']}")
    if out["served"] != SERVE_REQUESTS or out["shed"] or \
            len(gen) != SERVE_REQUESTS * NEW_TOKENS or \
            not all(0 <= t < cfg.vocab for t in gen):
        raise AssertionError(f"{arch}: the server did not serve every "
                             f"request its {NEW_TOKENS} in-vocabulary tokens")
    if launches != len(srv.timings) * cfg.n_layers:
        raise AssertionError(f"{arch}: {launches} launches of "
                             f"{kernel.__name__}, want one a layer a batch")
    return out, launches


def first_prefill(out):
    """The main path's first prefill: batch 1's padded prefix on the card,
    with the model and its config."""
    import numpy as np
    import torch

    srv = out["server"]
    batch = out["requests"][:SERVE_BATCH]
    P = max(len(r.prompt) for r in batch)
    pad = np.zeros((len(batch), P), np.int64)
    for i, r in enumerate(batch):
        pad[i, :len(r.prompt)] = r.prompt
    return srv.params, srv.model_cfg, torch.from_numpy(pad[:, :P - 1]).cuda()


def attention_problems(out):
    """B5's main problem (layer 0 of batch 1 of phase 11's prefill) and
    edge problems: S = 2, 13, 129; groups 1, 3, 8; hd 16, 64, 128; causal
    and full; float32 and bfloat16; then the tensor-core route's edges:
    bfloat16 at hd 16, 32, 128, S = 65 and 127 (a ragged 64-row tile).
    Returns [(tag, q, k, v, causal)]."""
    import torch

    from repro_torch.models import layers, transformer

    params, cfg, prefix = first_prefill(out)
    x = layers.embed(params, prefix, cfg)
    q, k, v = transformer.qkv(params.layers[0], x, cfg,
                              torch.arange(prefix.shape[1], device="cuda"))
    probs = [("main: layer 0 of batch 1", q, k, v, True)]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    for B, S, H, KV, hd, dt, causal in (
            (1, 2, 8, 1, 16, torch.float32, True),
            (2, 13, 6, 2, 64, torch.bfloat16, True),
            (2, 13, 6, 2, 64, torch.float32, False),
            (1, 129, 8, 8, 128, torch.bfloat16, False),
            (2, 129, 8, 1, 128, torch.float32, True),
            (1, 129, 15, 5, 16, torch.bfloat16, True),
            (1, 65, 8, 8, 16, torch.bfloat16, True),
            (2, 65, 6, 2, 16, torch.bfloat16, False),
            (1, 127, 8, 1, 32, torch.bfloat16, True),
            (2, 65, 3, 1, 32, torch.bfloat16, False),
            (1, 127, 15, 5, 128, torch.bfloat16, True),
            (1, 65, 8, 1, 128, torch.bfloat16, False)):
        qkv = [torch.randn((B, S, n, hd), generator=gen, device="cuda").to(dt)
               for n in (H, KV, KV)]
        probs.append((f"B={B} S={S} H={H} KV={KV} hd={hd} "
                      f"{str(dt)[6:]} causal={causal}", *qkv, causal))
    return probs


def attention_row(q, k, v, causal):
    """B5 on one problem: its time, the plain version's and SDPA's (the
    library call for the same function), by CUDA events behind a spin,
    and its bound."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                     operations)

    B, S, H, hd = q.shape
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    nbytes = _nbytes(q, k, v, q)
    # QK^T and PV: j <= i under causal masking, every j otherwise
    ops = operations(B, S, H, hd, causal)
    bound, by = _bound(nbytes, ops, str(q.dtype)[6:])
    return dict(
        shape=[B, S, H, k.shape[2], hd], causal=causal, bytes=nbytes,
        ops=ops,
        ms=_time_ms(lambda: flash_attention_cuda(q, k, v, causal=causal),
                    50),
        plain_ms=_time_ms(lambda: ref.flash_attention_plain(
            q, k, v, causal=causal), 10),
        library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 50),
        bound_ms=bound, bound_by=by)


def attention_parity(tag, q, k, v, causal) -> float:
    """B5 against its plain version on one problem, at the reference's
    tolerance for the dtype; returns the max abs error."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    got = flash_attention_cuda(q, k, v, causal=causal)
    want = ref.flash_attention_plain(q, k, v, causal=causal)
    e = _max_abs_err((got.float(),), (want.float(),))
    ok = _within(got, want, ATTN_TOL[str(q.dtype)[6:]])
    print(f"parity [flash_attention, {tag}] max_abs_err={e} (max "
          f"|plain| {float(want.float().abs().max()):.4g}) within "
          f"tolerance {ok}")
    if not ok:
        raise AssertionError(f"flash_attention disagrees with plain: {tag}")
    return e


def flash_check_and_time(out):
    """Phase 11's kernel row: B5 against its plain version on every problem,
    then kernel, plain version and SDPA timed on the main problem, and its
    bound."""
    problems = attention_problems(out)
    err = max(attention_parity(*p) for p in problems)
    _, q, k, v, _ = problems[0]
    row = dict(max_abs_err=err, **attention_row(q, k, v, True))
    del row["causal"]
    print(f"timing [flash_attention, main problem] {json.dumps(row)}")
    return row


def scan_problems(out):
    """B6's main problem (layer 0 of batch 1 of phase 12's prefill) and
    edge problems: T = 2, 13, 64, 509; a nonzero s0; float32 and bfloat16;
    then the chunked form's edges: w at the clamp (1e-12 everywhere), w
    mixing 1e-6 and 0.999, and T = C - 1, C, C + 1 around its chunk C.
    Returns [(tag, r, k, v, w, u, s0)]."""
    import torch

    from repro_torch.kernels.rwkv6_scan import CHUNK
    from repro_torch.models import layers, rwkv6

    params, cfg, prefix = first_prefill(out)
    lp = params.layers[0]
    x = layers.rmsnorm(lp.att_norm, layers.embed(params, prefix, cfg),
                       cfg.norm_eps)
    r, k, v, w, _, _ = rwkv6.time_mix_inputs(
        lp.rwkv, x, torch.zeros(x.shape[0], cfg.d_model, device="cuda"), cfg)
    B, T, H, hd = r.shape
    probs = [("main: layer 0 of batch 1", r, k, v, w, lp.rwkv.bonus_u,
              torch.zeros(B, H, hd, hd, device="cuda"))]
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n = lambda *s: torch.randn(s, generator=gen, device="cuda")
    for B, T, H, dt in ((2, 2, 4, torch.float32), (2, 13, 8, torch.bfloat16),
                        (1, 64, 40, torch.float32), (2, 509, 8, torch.float32),
                        (2, 509, 8, torch.bfloat16)):
        probs.append((f"B={B} T={T} H={H} {str(dt)[6:]} s0!=0",
                      *(n(B, T, H, 64).to(dt) for _ in range(3)),
                      torch.sigmoid(n(B, T, H, 64)) * 0.5 + 0.4,
                      n(H, 64) * 0.1, n(B, H, 64, 64) * 0.2))
    decays = {
        "sigmoid": lambda *s: torch.sigmoid(n(*s)) * 0.5 + 0.4,
        "clamp": lambda *s: torch.full(s, 1e-12, device="cuda"),
        "mixed": lambda *s: torch.where(n(*s) > 0, 1e-6, 0.999),
    }
    for B, T, H, hd, dt, decay in (
            (2, 64, 8, 64, torch.float32, "clamp"),
            (1, 40, 4, 64, torch.bfloat16, "clamp"),
            (2, 64, 8, 64, torch.float32, "mixed"),
            (1, 509, 8, 64, torch.bfloat16, "mixed"),
            (2, CHUNK - 1, 8, 64, torch.float32, "sigmoid"),
            (2, CHUNK, 8, 32, torch.float32, "sigmoid"),
            (2, CHUNK + 1, 8, 128, torch.bfloat16, "sigmoid")):
        probs.append((f"B={B} T={T} H={H} hd={hd} {str(dt)[6:]} w {decay}",
                      *(n(B, T, H, hd).to(dt) for _ in range(3)),
                      decays[decay](B, T, H, hd), n(H, hd) * 0.1,
                      n(B, H, hd, hd) * 0.2))
    return probs


def scan_check_and_time(out):
    """Phase 12's kernel row: B6 against its plain version on every problem,
    then both timed on the main problem, and its bound."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv6_scan import operations, rwkv6_scan_cuda

    err = 0.0
    problems = scan_problems(out)
    for tag, *args in problems:
        got = rwkv6_scan_cuda(*args)
        want = ref.rwkv6_scan_plain(*args)
        e = _max_abs_err((got[0].float(), got[1]), (want[0].float(), want[1]))
        out_tol, state_tol = SCAN_TOL[str(args[0].dtype)[6:]]
        ok = _within(got[0], want[0], out_tol) and \
            _within(got[1], want[1], state_tol)
        print(f"parity [rwkv6_scan, {tag}] max_abs_err={e} (max |plain| "
              f"{float(want[0].float().abs().max()):.4g}) within tolerance "
              f"{ok}")
        if not ok:
            raise AssertionError(f"rwkv6_scan disagrees with plain: {tag}")
        err = max(err, e)
    _, r, k, v, w, u, s0 = problems[0]
    B, T, H, hd = r.shape
    nbytes = _nbytes(r, k, v, w, u, s0, r, s0)
    ops = operations(B, T, H, hd)
    bound, by = _bound(nbytes, ops, "float32")
    row = dict(max_abs_err=err, shape=[B, T, H, hd], bytes=nbytes, ops=ops,
               ms=_time_ms(lambda: rwkv6_scan_cuda(r, k, v, w, u, s0), 20),
               plain_ms=_time_ms(lambda: ref.rwkv6_scan_plain(
                   r, k, v, w, u, s0), 2),
               library_ms=None, bound_ms=bound, bound_by=by)
    print(f"timing [rwkv6_scan, main problem] {json.dumps(row)}")
    return row


def card_against_cpu():
    """Phase 13: both reduced configurations (float32) through ``Server``,
    the kernels on the card against the plain path on the CPU, on the same
    weights and prompts."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    from repro_torch.runtime.serve import ServeConfig, Server

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch, kernel in (("smollm-360m", flash_attention_cuda),
                         ("rwkv6-3b", rwkv6_scan_cuda)):
        cfg = registry.get_config(arch).reduced()
        on_cpu = registry.init_params(cfg, seed=SEED, device="cpu")
        on_card = copy.deepcopy(on_cpu).cuda()
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab, rng.integers(2, 41)).astype(
            np.int32) for _ in range(8)]
        gens, before = [], kernel.launches
        for model, dev in ((on_card, "cuda"), (on_cpu, "cpu")):
            srv = Server(cfg, model, ServeConfig(max_new_tokens=8,
                                                 capacity=64), device=dev)
            reqs = [srv.admit(p) for p in prompts]
            for i in range(0, 8, 4):
                srv.serve_batch(reqs[i:i + 4])
            gens.append([r.generated for r in reqs])
        launches = kernel.launches - before
        # the first decode step's logits of batch 1, on both devices
        lg = []
        for model, dev in ((on_card, "cuda"), (on_cpu, "cpu")):
            batch = prompts[:4]
            P = max(len(p) for p in batch)
            pad = np.zeros((4, P), np.int64)
            for i, p in enumerate(batch):
                pad[i, :len(p)] = p
            toks = torch.from_numpy(pad).to(dev)
            _, cache = registry.make_prefill_fn(cfg, 64)(
                model, {"tokens": toks[:, :P - 1]})
            lg.append(registry.make_decode_fn(cfg)(model, cache,
                                                   toks[:, P - 1])[0].cpu())
        err = float((lg[0] - lg[1]).abs().max())
        print(f"small run ({arch}, reduced, float32): card kernels == CPU "
              f"plain path tokens: {gens[0] == gens[1]}; first-step logits "
              f"max_abs_err={err}; {kernel.__name__} launches={launches}")
        # the card's two served batches, one launch a layer each
        if gens[0] != gens[1] or not err <= 1e-4 or \
                launches != 2 * cfg.n_layers:
            raise AssertionError(f"{arch}: the card's serving differs from "
                                 f"the CPU's")


FAMILIES = ("olmoe-1b-7b", "hymba-1.5b", "llama-3.2-vision-11b",
            "whisper-tiny")   # served by teacher-forced decode steps


def _recording(decode, logs):
    """``decode`` that also keeps each step's logits, on the host."""
    def step(params, cache, token):
        lg, cache = decode(params, cache, token)
        logs.append(lg.cpu())
        return lg, cache
    return step


def families_card_against_cpu():
    """Phase 13 (b): the moe, hybrid, vlm and audio families, reduced
    (float32), through ``Server`` on the card and on the CPU, on the same
    weights and prompts: the same tokens, every decode step's logits
    within 1e-4, and B5 launched (float32 route) once an encoder layer a
    batch for the audio family's encoder, never for the others."""
    import copy

    import numpy as np
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.runtime.serve import ServeConfig, Server

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for arch in FAMILIES:
        cfg = registry.get_config(arch).reduced()
        on_cpu = registry.init_params(cfg, seed=SEED, device="cpu")
        on_card = copy.deepcopy(on_cpu).cuda()
        rng = np.random.default_rng(SEED)
        prompts = [rng.integers(0, cfg.vocab, rng.integers(2, 41)).astype(
            np.int32) for _ in range(8)]
        gens, logs, before = [], [], flash_attention_cuda.launches
        for model, dev in ((on_card, "cuda"), (on_cpu, "cpu")):
            srv = Server(cfg, model, ServeConfig(max_new_tokens=8,
                                                 capacity=64), device=dev)
            logs.append([])
            srv._decode = _recording(srv._decode, logs[-1])
            reqs = [srv.admit(p) for p in prompts]
            for i in range(0, 8, 4):
                srv.serve_batch(reqs[i:i + 4])
            gens.append([r.generated for r in reqs])
        launches = flash_attention_cuda.launches - before
        err = max(float((a - b).abs().max()) for a, b in zip(*logs))
        want = 2 * cfg.enc_layers if cfg.family == "audio" else 0
        print(f"small run ({arch}, reduced, float32): card == CPU tokens: "
              f"{gens[0] == gens[1]}; {len(logs[0])} decode steps' logits "
              f"max_abs_err={err}; flash_attention launches={launches}")
        if gens[0] != gens[1] or len(logs[0]) != len(logs[1]) or \
                not err <= 1e-4 or launches != want:
            raise AssertionError(f"{arch}: the card's serving differs from "
                                 f"the CPU's")


def small_dense_and_2pc(small):
    """Phase 6's second half: the dense escrow layout through each kernel
    and the strict 2PC baseline through the escrow_admit kernel, on the
    card, against the plain path on the CPU, bit for bit. The 2PC run
    starts from the uninflated stock, so that its strict floor aborts."""
    from repro_torch.txn import TwoPCEngine, init_state, run_closed_loop_2pc

    cpu = lambda t: type(t)(*(x.cpu() for x in t))
    counts = lambda m: (m.neworders, m.aborts, m.cold_rejects, m.refreshes,
                        m.anti_entropy_rounds)
    sc, ec, mc, _ = escrow_run(small, "scan", "scan", device="cpu", batch=16,
                               n_batches=6, audit=False,
                               escrow_layout="dense")
    for effects in ("fused", "scan"):
        sk, ek, mk, _ = escrow_run(small, "kernel", effects, device="cuda",
                                   batch=16, n_batches=6,
                                   escrow_layout="dense")
        bad = _same(cpu(sk), sc) + _same(cpu(ek), ec)
        if bad or counts(mk) != counts(mc):
            raise AssertionError(f"small dense run (effects={effects}): "
                                 f"card != CPU plain path: {bad} "
                                 f"{counts(mk)} {counts(mc)}")
        print(f"small run (dense escrow, effects={effects}): card kernels "
              f"== CPU plain path, counts {counts(mk)}")
    runs = []
    for dev in ("cuda", "cpu"):
        two = TwoPCEngine(small, strict_stock=True, device=dev)
        runs.append(run_closed_loop_2pc(
            two, init_state(small, seed=SEED, device=dev),
            batch_per_shard=16, n_batches=6, remote_frac=REMOTE_FRAC,
            seed=SEED, item_skew=ITEM_SKEW))
    (sk, mk), (sc, mc) = runs
    bad = _same(cpu(sk), sc)
    if bad or (mk.committed, mk.aborted) != (mc.committed, mc.aborted) \
            or mk.aborted <= 0:
        raise AssertionError(f"small strict 2PC run: card != CPU plain "
                             f"path, or nothing aborted: {bad} "
                             f"{(mk.committed, mk.aborted)} "
                             f"{(mc.committed, mc.aborted)}")
    print(f"small run (strict 2PC): card kernels == CPU plain path, "
          f"committed {mk.committed}, aborted {mk.aborted}")


def dense_escrow(scale, eng, sparse):
    """Phase 14: the dense layout on phase 4's stream, through the
    megastep kernel and through the escrow_admit kernel, launch counts
    from 0 before each; the sparse layout with a full hot set; the strict
    audit; both kernels on the dense problem after the run. ``sparse`` is
    phase 4's (megastep stats, escrow_admit stats). Returns (the dense
    megastep run's state and stats, each kernel's launches, the timing
    row)."""
    import torch

    from repro_torch.kernels.escrow_admit import escrow_admit_cuda
    from repro_torch.kernels.txn_megastep import txn_megastep_cuda
    from repro_torch.txn import tpcc

    runs, launches = {}, {}
    for effects in ("fused", "scan"):
        escrow_admit_cuda.launches = 0
        txn_megastep_cuda.launches = 0
        runs[effects] = escrow_run(scale, "kernel", effects,
                                   audit=effects == "fused",
                                   escrow_layout="dense")
        launches[effects] = (escrow_admit_cuda.launches,
                             txn_megastep_cuda.launches)
    s_full, e_full, m_full, _ = escrow_run(scale, "kernel", "fused",
                                           audit=False,
                                           hot_items=scale.n_items)
    (s_d, e_d, m_d, rep), (s_a, e_a, m_a, _) = runs["fused"], runs["scan"]
    fused_b1, fused_b2 = launches["fused"]
    scan_b1, scan_b2 = launches["scan"]
    if (fused_b1, fused_b2, scan_b1, scan_b2) != (0, N_BATCHES + 1,
                                                  N_BATCHES + 1, 0):
        raise AssertionError(f"dense runs missed their kernel: {launches}")
    counts = lambda m: (m.neworders, m.aborts, m.cold_rejects, m.refreshes,
                        m.anti_entropy_rounds)
    bad = _same(s_d, s_a) + _same(e_d, e_a) + _same(s_d, s_full)
    bad += [f"escrow {f}" for f, x, y in zip(e_d._fields, e_d[:2], e_full[1:])
            if not torch.equal(x.reshape(-1), y.reshape(-1))]
    if bad or len({counts(m) for m in (m_d, m_a, m_full)}) != 1:
        raise AssertionError(f"dense escrow: megastep != escrow_admit != "
                             f"full hot set: {bad} {counts(m_d)} "
                             f"{counts(m_a)} {counts(m_full)}")
    if "escrow_covers_stock" not in rep or m_d.aborts <= 0:
        raise AssertionError("the dense audit did not cover the stock, or "
                             "nothing aborted")
    sizes = tpcc.escrow_layout_bytes(scale, tpcc.default_hot_items(scale))
    print(f"dense escrow (megastep kernel): {m_d.neworders} committed, "
          f"{m_d.aborts} aborts, {m_d.cold_rejects} cold rejects, "
          f"{m_d.throughput:,.0f} txn/s; txn_megastep launches={fused_b2};"
          f" {rep}")
    print(f"dense escrow (escrow_admit kernel): {m_a.neworders} committed, "
          f"{m_a.throughput:,.0f} txn/s; escrow_admit launches={scan_b1}")
    print(f"sparse escrow, full hot set (K={scale.n_warehouses * scale.n_items:,}): "
          f"{m_full.throughput:,.0f} txn/s; bit-equal to dense (state, "
          f"spent, shares, counts {counts(m_d)})")
    print(f"escrow layouts: phase 4's sparse (K={sizes['hot_cells']:,}) "
          f"{sparse[0].throughput:,.0f} txn/s through the megastep, "
          f"{sparse[1].throughput:,.0f} through escrow_admit, "
          f"{sizes['sparse_bytes_per_device']:,} bytes of escrow a device; "
          f"dense {m_d.throughput:,.0f} and {m_a.throughput:,.0f} txn/s, "
          f"{sizes['dense_bytes_per_device']:,} bytes a device")
    # the problem the dense run's next batch meets: 6.4 M cells of avail
    batch = main_path_batch(eng, N_BATCHES)
    timing = check_and_time("dense layout after the run", *tpcc.megastep_args(
        s_d, batch, scale, (e_d.shares[0] - e_d.spent[0]).reshape(-1),
        batch.supply_w * scale.n_items + batch.i_id,
        tpcc.order_line_valid(batch), batch.ts, 0, scale.n_warehouses))
    return s_d, m_d, {"escrow_admit": scan_b1,
                      "txn_megastep": fused_b2}, timing


def coordinated_baseline(scale, merge, s_merge, s_mix, s_dense, m_dense,
                         best_escrow):
    """Phase 15: the strict 2PC baseline on phase 4's stream (launch counts
    from 0), its audit and throughputs without and with the modeled
    commitment latency; the non-strict baseline against phase 3's
    ``s_merge``; ``read_step`` on phase 7's ``s_mix``. Returns each
    kernel's launches."""
    import numpy as np

    from repro_torch.kernels.escrow_admit import escrow_admit_cuda
    from repro_torch.kernels.ramp_read import ramp_read_cuda
    from repro_torch.txn import (TwoPCEngine, assert_audit, init_state,
                                 plan_engine, run_closed_loop_2pc, tpcc)
    from repro_torch.txn.drivers import generate_mix_batches
    from repro_torch.txn.latency import DelayModel, simulate
    from repro_torch.txn.twopc import _conflict_rounds

    two = plan_engine(scale, stock_invariant="serial")
    if not (isinstance(two, TwoPCEngine) and two.strict_stock):
        raise AssertionError(f"plan_engine(serial) returned {two!r}")
    lat = simulate("D-2PC", DelayModel("lan"), 2, trials=400)
    commit_s = lat.mean_latency_ms / 1e3
    state = init_state(scale, seed=SEED)
    state.s_quantity.mul_(STOCK_MULTIPLIER)
    q0 = state.s_quantity.clone()
    escrow_admit_cuda.launches = 0
    s2, st2 = run_closed_loop_2pc(
        two, state, batch_per_shard=BATCH, n_batches=N_BATCHES,
        remote_frac=REMOTE_FRAC, seed=SEED, item_skew=ITEM_SKEW)
    b1 = escrow_admit_cuda.launches
    del state
    t0 = time.perf_counter()
    rep = assert_audit(s2, initial_stock=q0, strict_stock=True).describe()
    rep += f" in {time.perf_counter() - t0:.1f} s"
    # on one shard the escrow's one replica spends from the whole pool
    # between refreshes: the same transactions commit, in the same state
    bad = [f"dense {f}" for f in _same(s2, s_dense)]
    if bad or b1 != N_BATCHES + 1:
        raise AssertionError(f"strict 2PC: runs differ {bad}, escrow_admit "
                             f"launches={b1}")
    if st2.committed < m_dense.neworders:
        raise AssertionError("2PC committed less than escrow on the "
                             "identical stream")
    # the charge run_closed_loop_2pc(commit_latency_s=commit_s) would add,
    # counted on the host from the same stream: commit_s x rounds
    rng = np.random.default_rng(SEED)
    rounds = sum(_conflict_rounds(tpcc.generate_neworder(
        rng, scale, BATCH, remote_frac=REMOTE_FRAC, ts0=i * BATCH,
        item_skew=ITEM_SKEW, device="cpu"), scale.districts)
        for i in range(N_BATCHES))
    wall_lat = st2.wall_seconds + commit_s * rounds
    tput_lat = st2.committed / wall_lat
    print(f"strict 2PC (plan_engine(serial), escrow_admit kernel): "
          f"{st2.committed} committed, {st2.aborted} aborted (dense escrow: "
          f"{m_dense.neworders}; bit-equal states); escrow_admit "
          f"launches={b1}; {rep}")
    print(f"modeled commitment latency (a model, not a measurement): D-2PC "
          f"over a LAN, 2 servers, latency.simulate with 400 trials: mean "
          f"{lat.mean_latency_ms} ms, p95 {lat.p95_latency_ms} ms; "
          f"{rounds} conflicting rounds in {N_BATCHES} batches")
    print(f"strict 2PC throughput: {st2.throughput:,.0f} txn/s on the "
          f"card's wall time alone ({st2.wall_seconds:.4f} s); "
          f"{tput_lat:,.2f} txn/s with the modeled latency charged to the "
          f"same run ({wall_lat:.3f} s); best escrow run of this call "
          f"{best_escrow:,.0f} txn/s: {best_escrow / tput_lat:,.1f}x over "
          f"2PC with the latency, {best_escrow / st2.throughput:.2f}x "
          f"without")

    state, st = run_closed_loop_2pc(
        TwoPCEngine(scale), init_state(scale, seed=SEED),
        batch_per_shard=BATCH, n_batches=N_BATCHES, remote_frac=REMOTE_FRAC,
        seed=SEED)
    bad = _same(state, s_merge)
    print(f"non-strict 2PC over phase 3's stream: {st.committed} committed "
          f"in the timed batches, {st.throughput:,.0f} txn/s; state equal to "
          f"phase 3's (s_ytd, d_next_o_id and every other table): "
          f"{not bad}")
    if bad:
        raise AssertionError(f"non-strict 2PC != merge regime: {bad}")
    del state

    os_batch = generate_mix_batches(
        merge, batch_per_shard=BATCH, n_batches=1, remote_frac=REMOTE_FRAC,
        read_frac=READ_FRAC, seed=SEED)[2][0]
    wl, d = os_batch.w.long(), os_batch.d.long()
    OC = s_mix.o_c_id.shape[-1]
    latest = ((s_mix.d_next_o_id[wl, d] - 1) % OC).long()
    owners = os_batch._replace(c=s_mix.o_c_id[wl, d, latest])
    # on one shard read_step reads as order_status_step does (its grant and
    # vote pass every query): what this shows on the card is that 2PC's
    # read path launches ramp_read; phase 16 reads four shards
    ramp_read_cuda.launches = 0
    got = two.read_step(s_mix, owners)
    reads = ramp_read_cuda.launches
    bad = _same(got, merge.order_status_step(s_mix, owners))
    print(f"2PC read_step on phase 7's state: {int(got.found.sum())} of "
          f"{len(owners.w)} found, equal to Engine.order_status_step: "
          f"{not bad}; ramp_read launches={reads}")
    if bad or reads != 1 or int(got.found.sum()) <= 0:
        raise AssertionError(f"2PC read_step != order_status_step: {bad}")
    return {"escrow_admit": b1, "ramp_read": reads}


SHARDS = 4                 # phase 16: replicas of the deployment on one card


def replicas_on_one_card(scale):
    """Phase 16: the deployment as ``SHARDS`` replicas of W / SHARDS
    warehouses on one card (``Engine(n_shards=SHARDS)``), BATCH // SHARDS
    New-Orders a shard a batch, launch counts from 0 before each run.
    Merge New-Order and the merge mix (audits, no fracture); sparse escrow
    through B2 and through B1 and dense escrow through B2 (strict audits),
    each bit-equal to its layout's plain run on the card; B1 and B2 on
    each shard's next problem and B3 on each shard's Order-Status problem
    against their plain versions; strict 2PC on the same per-shard stream
    (B1 once a batch), with and without the modeled latency; ``read_step``
    against ``order_status_step``; the structural proofs; a small run on
    the card against the CPU plain path. Returns each kernel's launches."""
    import numpy as np
    import torch

    from repro_torch.kernels.escrow_admit import escrow_admit_cuda
    from repro_torch.kernels.ramp_read import ramp_read_cuda
    from repro_torch.kernels.txn_megastep import txn_megastep_cuda
    from repro_torch.txn import (TPCCScale, TwoPCEngine, assert_audit,
                                 collectives, init_state, ramp,
                                 run_closed_loop_2pc, run_loop)
    from repro_torch.txn.drivers import (generate_mix_batches,
                                         generate_neworder_stream)
    from repro_torch.txn.engine import Engine, batch_parts
    from repro_torch.txn.latency import DelayModel, simulate
    from repro_torch.txn.twopc import _conflict_rounds

    R, bps = SHARDS, BATCH // SHARDS
    per_run = R * (N_BATCHES + 1)       # a launch a shard a batch + warm-up
    loop = dict(batch_per_shard=bps, n_batches=N_BATCHES,
                remote_frac=REMOTE_FRAC, merge_every=MERGE_EVERY, seed=SEED,
                fused=False)
    counts = lambda m: (m.neworders, m.aborts, m.cold_rejects, m.refreshes,
                        m.anti_entropy_rounds)
    launches = dict.fromkeys(("escrow_admit", "txn_megastep", "ramp_read"),
                             0)
    print(f"replicas: {R} shards of {scale.n_warehouses // R} warehouses on "
          f"one card, {bps} New-Orders a shard a batch")

    merge = Engine(scale, n_shards=R)
    s, _, st = run_loop(merge, init_state(scale, seed=SEED), **loop)
    rep = assert_audit(s).describe()
    print(f"replicas, merge: {st.neworders} committed, {st.throughput:,.0f} "
          f"txn/s, {st.anti_entropy_rounds} anti-entropy rounds; {rep}")
    del s
    ramp_read_cuda.launches = 0
    s_mix, _, mm = run_loop(merge, init_state(scale, seed=SEED), **loop,
                            **MIX)
    b3 = ramp_read_cuda.launches
    rep = assert_audit(s_mix).describe()
    print(f"replicas, merge mix: {mm.neworders} New-Order, {mm.payments} "
          f"Payment, {mm.order_statuses} Order-Status ({mm.reads_found} "
          f"found), {mm.stock_levels} Stock-Level, {mm.deliveries} "
          f"Delivery; {mm.throughput:,.0f} txn/s; fractures_observed="
          f"{mm.fractures_observed}; ramp_read launches={b3}; {rep}")
    if mm.fractures_observed or b3 != per_run:
        raise AssertionError(f"replicas: the merge mix fractured or missed "
                             f"ramp_read ({b3} launches, want {per_run})")
    launches["ramp_read"] += b3

    # each layout through its kernels and through the plain path (the
    # definitional sequential walk, which shares no code with B1 or B2)
    runs, dense = {}, dict(escrow_layout="dense")
    for tag, admission, effects, kw in (
            ("sparse, megastep", "kernel", "fused", {}),
            ("sparse, escrow_admit", "kernel", "scan", {}),
            ("sparse, plain", "scan", "scan", {}),
            ("dense, megastep", "kernel", "fused", dense),
            ("dense, plain", "scan", "scan", dense)):
        escrow_admit_cuda.launches = txn_megastep_cuda.launches = 0
        runs[tag] = escrow_run(scale, admission, effects, batch=bps,
                               audit=admission == "kernel", n_shards=R, **kw)
        got = (escrow_admit_cuda.launches, txn_megastep_cuda.launches)
        want = {"fused": (0, per_run), "scan": (per_run, 0)}[effects] \
            if admission == "kernel" else (0, 0)
        _, esc, m, rep = runs[tag]
        print(f"replicas, escrow ({tag}): {m.neworders} committed, "
              f"{m.aborts} aborts, {m.cold_rejects} cold rejects, "
              f"{m.refreshes} refreshes, {m.throughput:,.0f} txn/s; "
              f"escrow_admit/txn_megastep launches={got}; shares "
              f"{tuple(esc.shares.shape)}; {rep}")
        if got != want or esc.shares.shape[0] != R:
            raise AssertionError(f"replicas, escrow ({tag}): launches {got}, "
                                 f"want {want}")
        launches["escrow_admit"] += got[0]
        launches["txn_megastep"] += got[1]
    for layout, kernels in (("sparse", ("megastep", "escrow_admit")),
                            ("dense", ("megastep",))):
        s_p, e_p, m_p, _ = runs[f"{layout}, plain"]
        for k in kernels:
            s_k, e_k, m_k, _ = runs[f"{layout}, {k}"]
            bad = _same(s_k, s_p) + _same(e_k, e_p)
            if bad or counts(m_k) != counts(m_p):
                raise AssertionError(f"replicas, {layout}: {k} != plain "
                                     f"path: {bad} {counts(m_k)} "
                                     f"{counts(m_p)}")
        print(f"replicas: {layout} escrow through {' and '.join(kernels)} "
              f"bit-equal to the plain path on the card (state, shares, "
              f"spent, counts {counts(m_p)})")
    best = max(r[2].throughput for tag, r in runs.items()
               if "plain" not in tag)

    # each shard's B1 and B2 problem for the next batch, at the end of each
    # layout's kernel run, against the plain versions
    escrows = [Engine(scale, stock_invariant="strict", admission="kernel",
                      effects="fused", escrow_layout=lay, n_shards=R)
               for lay in ("sparse", "dense")]
    n_res = []
    for eng in escrows:
        s_k, e_k, _, _ = runs[f"{eng.escrow_layout}, megastep"]
        batch = main_path_batch(eng, N_BATCHES, bps)
        for r in range(R):
            row = check_and_time(
                f"shard {r} of {R}, {eng.escrow_layout}, after the run",
                *admission_problem(eng, s_k, e_k, batch, r))
            n_res.append(row["txn_megastep"]["n_res"])
    if not any(n_res):
        raise AssertionError("replicas: no shard problem has residual work")
    del runs, s_p, e_p, s_k, e_k
    torch.cuda.empty_cache()

    two = TwoPCEngine(scale, strict_stock=True, n_shards=R)
    lat = simulate("D-2PC", DelayModel("lan"), 2, trials=400)
    commit_s = lat.mean_latency_ms / 1e3
    state = init_state(scale, seed=SEED)
    state.s_quantity.mul_(STOCK_MULTIPLIER)
    q0 = state.s_quantity.clone()
    escrow_admit_cuda.launches = 0
    s2, st2 = run_closed_loop_2pc(two, state, batch_per_shard=bps,
                                  n_batches=N_BATCHES,
                                  remote_frac=REMOTE_FRAC, seed=SEED,
                                  item_skew=ITEM_SKEW)
    b1 = escrow_admit_cuda.launches
    del state
    rep = assert_audit(s2, initial_stock=q0, strict_stock=True).describe()
    del s2, q0
    if b1 != N_BATCHES + 1:
        raise AssertionError(f"replicas, strict 2PC: {b1} escrow_admit "
                             f"launches, want one a batch")
    launches["escrow_admit"] += b1
    rounds = sum(_conflict_rounds(b, scale.districts)
                 for b in generate_neworder_stream(
                     two, batch_per_shard=bps, n_batches=N_BATCHES,
                     remote_frac=REMOTE_FRAC,
                     rng=np.random.default_rng(SEED), item_skew=ITEM_SKEW))
    wall_lat = st2.wall_seconds + commit_s * rounds
    tput_lat = st2.committed / wall_lat
    print(f"replicas, strict 2PC: {st2.committed} committed, {st2.aborted} "
          f"aborted; escrow_admit launches={b1}; {rep}")
    print(f"replicas, strict 2PC throughput: {st2.throughput:,.0f} txn/s on "
          f"the card's wall time alone ({st2.wall_seconds:.4f} s); "
          f"{tput_lat:,.2f} txn/s with the modeled D-2PC LAN latency "
          f"({lat.mean_latency_ms} ms x {rounds} rounds) charged to the same "
          f"run ({wall_lat:.3f} s); best escrow run {best:,.0f} txn/s: "
          f"{best / tput_lat:,.2f}x over 2PC with the latency, "
          f"{best / st2.throughput:.2f}x without")

    reader = TwoPCEngine(scale, n_shards=R)
    os_batch = generate_mix_batches(
        merge, batch_per_shard=bps, n_batches=1, remote_frac=REMOTE_FRAC,
        read_frac=READ_FRAC, seed=SEED)[2][0]
    wl, d = os_batch.w.long(), os_batch.d.long()
    OC = s_mix.o_c_id.shape[-1]
    latest = ((s_mix.d_next_o_id[wl, d] - 1) % OC).long()
    owners = os_batch._replace(c=s_mix.o_c_id[wl, d, latest])
    ramp_read_cuda.launches = 0
    with collectives.counted() as vote:
        got = reader.read_step(s_mix, owners)
    reads = ramp_read_cuda.launches
    want = merge.order_status_step(s_mix, owners)
    found = got.found
    bad = [f for f, x, y in zip(got._fields, got, want)
           if not torch.equal(x[found], y[found])]
    print(f"replicas, 2PC read_step: {int(found.sum())} of "
          f"{len(owners.w)} found, equal to Engine.order_status_step where "
          f"found: {not bad} (found equal: {torch.equal(found, want.found)});"
          f" ramp_read launches={reads}; {vote.describe()}")
    if bad or not torch.equal(found, want.found) or reads != R or \
            int(found.sum()) <= 0 or vote.total_ops <= 0:
        raise AssertionError(f"replicas: read_step != order_status_step: "
                             f"{bad}")
    launches["ramp_read"] += reads
    # each shard's B3 problem from that batch, on the state and on a copy
    # with half the lines concealed, against the plain version
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    hidden = ramp.conceal_lines(s_mix, torch.rand(
        s_mix.ol_vis.shape, generator=gen, device="cuda") < 0.5)
    for r, part in enumerate(batch_parts(owners, R)):
        w_lo = r * merge.w_per_shard
        for tag, st in (("", s_mix), (", half concealed", hidden)):
            view = merge.shard_view(st, r)
            slot, hit = ramp.order_status_slots(view, part, w_lo)
            row = ramp_read_check_and_time(
                f"shard {r} of {R}: Order-Status{tag}",
                ramp.order_status_lines(view, part, slot, hit, w_lo), 50)
            if tag and row["repaired"] <= 0:
                raise AssertionError(f"replicas: shard {r}'s concealed "
                                     f"read repaired no line")
    del s_mix, hidden
    torch.cuda.empty_cache()

    # the structural proofs, at the deployment's size
    free = {"merge hot path": merge.prove_coordination_free(8),
            "escrow hot path (sparse)": escrows[0].prove_coordination_free(8),
            "escrow hot path (dense)": escrows[1].prove_coordination_free(8),
            "RAMP reads": merge.prove_read_coordination_free(8)}
    paid = {"anti-entropy": merge.count_anti_entropy_collectives(8),
            "refresh (sparse)": escrows[0].count_refresh_collectives(),
            "refresh (dense)": escrows[1].count_refresh_collectives(),
            "2PC step": two.hot_path_collectives(8),
            "2PC read": reader.read_path_collectives(8)}
    for k, v in free.items():
        print(f"proof [{k}]: {v}; foreign slices untouched")
    for k, v in paid.items():
        print(f"proof [{k}]: {v.describe()}")
    if any(v.count("NONE") != (2 if k == "RAMP reads" else 1)
           for k, v in free.items()) or \
            any(v.total_ops <= 0 for v in paid.values()):
        raise AssertionError("replicas: a structural proof failed")
    del escrows
    torch.cuda.empty_cache()

    # a small run: the kernels on the card against the plain path on the CPU
    tiny = TPCCScale(n_warehouses=8, districts=4, customers=8, n_items=64,
                     order_capacity=64)
    cpu = lambda t: type(t)(*(x.cpu() for x in t))
    for tag, mix in (("New-Order", None), ("five-transaction mix", MIX)):
        sk, ek, mk, _ = escrow_run(tiny, "kernel", "fused", device="cuda",
                                   batch=16, n_batches=6, mix=mix,
                                   n_shards=R, hot_items=4)
        sc, ec, mc, _ = escrow_run(tiny, "scan", "scan", device="cpu",
                                   batch=16, n_batches=6, audit=False,
                                   mix=mix, n_shards=R, hot_items=4)
        bad = _same(cpu(sk), sc) + _same(cpu(ek), ec)
        if bad or counts(mk) != counts(mc):
            raise AssertionError(f"replicas, small run ({tag}): card != CPU "
                                 f"plain path: {bad} {counts(mk)} "
                                 f"{counts(mc)}")
        print(f"replicas, small run ({tag}, R={R}): card kernels == CPU "
              f"plain path, counts {counts(mk)}")
    return launches


# phase 17: the cold-retry ring. Phase 16's traffic (1% remote lines, the
# default hot set, stock x20) sends no cold line that an owner rejects, so
# the ring would idle; it gets work where cold cells contend across
# replicas: the reference's failure-row traffic (half the lines remote,
# Zipf 1.2; benchmarks/paper_figures.py's escrow_failures row), the
# specification's initial stock and a hot set of one item a warehouse
RING = dict(remote_frac=0.5, item_skew=ITEM_SKEW, merge_every=MERGE_EVERY,
            refresh_every=REFRESH_EVERY, seed=SEED)
RING_HOT_ITEMS = 1
RING_CAP = 256
RING_SPLIT = 16            # the resume: 16 batches, then 16 from seed 1
RING_RUNS = {"none": {},
             "rm0": dict(retry_cap=RING_CAP, retry_max=0),
             "rm3": dict(retry_cap=RING_CAP, retry_max=3),
             "reserve": dict(retry_cap=RING_CAP, retry_max=3,
                             retry_reserve=1),
             "noflush": dict(retry_cap=RING_CAP, retry_max=3,
                             final_flush=False),
             "alive": dict(retry_cap=RING_CAP, retry_max=3,
                           alive=[1, 1, 0, 1])}
# The JAX package's counts for these runs at this width: (committed,
# aborted, cold rejects, refreshes, ring lanes an owner, reserved lanes).
# Produced on the CPU (4 simulated devices, 71 s, 23 GB of host memory) by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_retry.py
RING_REFERENCE = {
    "none": (1332, 6860, 481, 4, None, None),
    "rm0": (1332, 6860, 481, 4, [0, 0, 0, 0], 0),
    "rm3": (1323, 6869, 446, 4, [103, 55, 106, 84], 0),
    "reserve": (1323, 6869, 446, 4, [103, 55, 106, 84], 1),
    "noflush": (1323, 6869, 98, 4, [103, 55, 106, 84], 0),
    "alive": (1295, 6897, 417, 4, [90, 58, 98, 74], 0),
    "split": (900, 3196, 0, 2, [77, 48, 64, 51], 0),
    "resume": (406, 3690, 415, 2, [96, 65, 86, 70], 0),
}


def ring_engine(scale, admission="kernel", effects="fused", device=None):
    """Phase 17's four-replica engine (``RING_HOT_ITEMS`` hot items)."""
    from repro_torch.txn.engine import Engine

    return Engine(scale, stock_invariant="strict", hot_items=RING_HOT_ITEMS,
                  admission=admission, effects=effects, device=device,
                  n_shards=SHARDS)


def ring_run(scale, tag, eng, state=None, esc=None, n_batches=None,
             audit=True, **over):
    """One run of ``RING_RUNS[tag]`` (``over`` replacing its knobs) under
    ``RING``'s traffic for ``n_batches`` (default ``N_BATCHES``), from
    ``init_state`` unless ``state`` is given, strictly audited; launch
    counts from 0; by dispatch unless ``over`` says ``fused=True``.
    Returns (state, escrow, stats, ring, (B1, B2) launches)."""
    import torch

    from repro_torch.kernels.escrow_admit import escrow_admit_cuda
    from repro_torch.kernels.txn_megastep import txn_megastep_cuda
    from repro_torch.txn import assert_audit, init_state, run_loop

    knobs = dict(RING_RUNS[tag], **over)
    if "alive" in knobs:
        knobs["alive"] = torch.tensor(knobs["alive"], dtype=torch.int32,
                                      device=eng.device)
    if state is None:
        state = init_state(scale, seed=SEED, device=eng.device)
    escrow_admit_cuda.launches = txn_megastep_cuda.launches = 0
    s, e, m, ring = run_loop(
        eng, state, esc, batch_per_shard=BATCH // SHARDS,
        n_batches=N_BATCHES if n_batches is None else n_batches,
        return_retry=True, **dict(dict(RING, fused=False), **knobs))
    got = (escrow_admit_cuda.launches, txn_megastep_cuda.launches)
    if audit:
        assert_audit(s, escrow=e, initial_stock=_initial_stock(scale),
                     strict_stock=True)
    return s, e, m, ring, got


_INITIAL_STOCK = {}


def _initial_stock(scale):
    """``init_state(scale, seed=SEED)``'s stock on the host, built once."""
    from repro_torch.txn import init_state

    if scale not in _INITIAL_STOCK:
        _INITIAL_STOCK[scale] = init_state(
            scale, seed=SEED, device="cpu").s_quantity
    return _INITIAL_STOCK[scale]


def ring_counts(m, ring):
    """A run's (committed, aborted, cold rejects, refreshes, ring lanes an
    owner, reserved lanes), the format of ``RING_REFERENCE``."""
    if ring is None:
        return (m.neworders, m.aborts, m.cold_rejects, m.refreshes,
                None, None)
    return (m.neworders, m.aborts, m.cold_rejects, m.refreshes,
            ring.valid.sum(1).tolist(), int(ring.reserved.sum()))


def cold_retry_ring(scale):
    """Phase 17: the cold-retry ring on ``SHARDS`` replicas at full width
    (phase 16's deployment under ``RING``'s traffic, ``RING_HOT_ITEMS``
    hot items a warehouse, the specification's stock), launch counts from
    0 before each run. Every row of ``RING_RUNS`` through the megastep
    (B2), its counts, ring lanes and reserved lanes held to the JAX
    package's (``RING_REFERENCE``) and strictly audited; ``retry_max=0``
    bit-equal to no ring; ``retry_max=3`` through escrow_admit (B1),
    through the plain path on the card and through the plain path on the
    CPU, each bit-equal to the B2 run (state, escrow, ring, counts); a run
    of ``RING_SPLIT`` batches with ``final_flush=False`` resumed through
    ``retry=`` for as many more, bit-equal to the CPU's two calls; one
    retry drain with the card's host-sync check on; txn/s of no ring,
    ``retry_max=0`` and ``retry_max=3`` in turns; the device time of one
    ``drain_strict_retry`` against one ``drain_strict`` on the same window,
    and of one owner's stock apply of that window against the apply of its
    own entries alone. Returns each kernel's launches."""
    import numpy as np
    import torch

    from repro_torch.txn import tpcc
    from repro_torch.txn.drivers import (_OutboxWindow,
                                         generate_neworder_stream)

    R, bps = SHARDS, BATCH // SHARDS
    launches = dict.fromkeys(("escrow_admit", "txn_megastep"), 0)
    cpu = lambda t: type(t)(*(x.cpu() for x in t))
    card = lambda t: type(t)(*(x.cuda() for x in t))

    def run(tag, eng, *args, **kw):
        """``ring_run``, its card launches added to the phase's."""
        out = ring_run(scale, tag, eng, *args, **kw)
        if eng.device.type == "cuda":
            launches["escrow_admit"] += out[4][0]
            launches["txn_megastep"] += out[4][1]
        return out

    def check(tag, m, ring, got, want_launches):
        c = ring_counts(m, ring)
        print(f"ring [{tag}]: {c[0]} committed, {c[1]} aborted, {c[2]} cold "
              f"rejects, {c[3]} refreshes, ring {c[4]}, {c[5]} reserved; "
              f"{m.throughput:,.0f} txn/s; escrow_admit/txn_megastep "
              f"launches={got}; strict audit OK")
        if c != RING_REFERENCE[tag] or got != want_launches:
            raise AssertionError(f"ring [{tag}]: {c} launches {got}, want "
                                 f"the JAX package's {RING_REFERENCE[tag]} "
                                 f"and launches {want_launches}")

    print(f"ring: {R} shards of {scale.n_warehouses // R} warehouses, {bps} "
          f"New-Orders a shard a batch, {RING['remote_frac']:.0%} remote "
          f"lines, {RING_HOT_ITEMS} hot item a warehouse, the spec's stock, "
          f"retry_cap={RING_CAP}")
    b2 = ring_engine(scale)
    per_run = (0, R * (N_BATCHES + 1))
    tput = {}
    runs = {}
    for tag in RING_RUNS:
        s, e, m, ring, got = run(tag, b2)
        check(tag, m, ring, got, per_run)
        tput.setdefault(tag, []).append(m.throughput)
        if tag == "alive" and (int(e.shares[2].sum()) != 0
                               or int(e.shares[0].sum()) <= 0):
            raise AssertionError("ring [alive]: the dead slot holds shares")
        if tag in ("none", "rm0", "rm3"):
            runs[tag] = (s, e, m, ring)
        del s, e
    s_n, e_n, m_n, _ = runs.pop("none")
    s_0, e_0, m_0, _ = runs.pop("rm0")
    bad = _same(s_n, s_0) + _same(e_n, e_0)
    if bad or ring_counts(m_n, None)[:4] != ring_counts(m_0, None)[:4]:
        raise AssertionError(f"ring: retry_max=0 != no ring: {bad}")
    print("ring: retry_max=0 bit-equal to no ring (state, escrow, counts)")
    del s_n, e_n, s_0, e_0
    torch.cuda.empty_cache()

    s3, e3, m3, r3 = runs.pop("rm3")
    for tag, eng, want in (
            ("escrow_admit", ring_engine(scale, "kernel", "scan"),
             (per_run[1], 0)),
            ("plain path on the card", ring_engine(scale, "scan", "scan"),
             (0, 0)),
            ("plain path on the CPU",
             ring_engine(scale, "scan", "scan", "cpu"), (0, 0))):
        s, e, m, ring, got = run("rm3", eng)
        bad = _same(s3, card(s)) + _same(e3, card(e)) + _same(r3, card(ring))
        if bad or ring_counts(m, ring) != ring_counts(m3, r3) or got != want:
            raise AssertionError(f"ring, retry_max=3: {tag} != txn_megastep:"
                                 f" {bad} {ring_counts(m, ring)} launches "
                                 f"{got}")
        print(f"ring, retry_max=3 through {tag}: bit-equal to txn_megastep "
              f"(state, escrow, ring, counts {ring_counts(m, ring)}); "
              f"{m.throughput:,.0f} txn/s; launches={got}")
        del s, e, ring
    torch.cuda.empty_cache()

    # final_flush=False for RING_SPLIT batches, then a resume through retry=
    ends = []
    for eng in (b2, ring_engine(scale, "scan", "scan", "cpu")):
        split = R * (RING_SPLIT + 1)
        s, e, m, ring, got = run("noflush", eng, n_batches=RING_SPLIT)
        if eng is b2:
            check("split", m, ring, got, (0, split))
        s, e, m, ring, got = run("noflush", eng, s, e, n_batches=RING_SPLIT,
                                 seed=SEED + 1, retry=ring, final_flush=True)
        if eng is b2:
            check("resume", m, ring, got, (0, split))
        ends.append((cpu(s), cpu(e), cpu(ring), ring_counts(m, ring)))
    bad = [f"{i}: {_same(x, y)}" for i, (x, y) in enumerate(zip(*ends))
           if i < 3 and _same(x, y)]
    if bad or ends[0][3] != ends[1][3]:
        raise AssertionError(f"ring: the resume on the card != the CPU's: "
                             f"{bad}")
    print(f"ring: {RING_SPLIT} batches with final_flush=False, resumed "
          f"through retry= for {RING_SPLIT} more: card == CPU (state, "
          f"escrow, ring, counts {ends[0][3]})")
    resume_end = ends[0]     # phase 18's disk resume must end here
    del ends

    # the next window after the retry_max=3 run: the ring's drain reads
    # nothing back to the host, and its device time beside the plain drain
    stream = generate_neworder_stream(
        b2, batch_per_shard=bps, n_batches=N_BATCHES + MERGE_EVERY,
        remote_frac=RING["remote_frac"], rng=np.random.default_rng(SEED),
        item_skew=ITEM_SKEW)
    work = tpcc.copy_tree(s3)
    window = None
    for batch in stream[N_BATCHES:]:
        _, _, outbox, _, _ = b2.neworder_escrow_step(work, e3, batch)
        if window is None:
            window = _OutboxWindow(outbox, MERGE_EVERY)
        window.put(outbox)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, ring, final = b2.drain_strict_retry(work, window.flat(), r3, 3, 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    print(f"ring: one drain_strict_retry under the host-sync check (none "
          f"made): {int(final.sum())} final rejects, ring "
          f"{ring.valid.sum(1).tolist()}")
    drains = {"drain_strict": lambda: b2.drain_strict(work, window.flat()),
              "drain_strict_retry": lambda: b2.drain_strict_retry(
                  work, window.flat(), r3, 3, 1)}
    drain_ms = {k: [] for k in drains}
    for k in list(drains) * 2:
        drain_ms[k].append(_time_ms(drains[k], 10))
    print(f"ring, device time of one drain of a {MERGE_EVERY}-batch window "
          f"(ms, in turns): {json.dumps(drain_ms)}")
    # what a drain's time is made of: owner 0's stock apply of the gathered
    # window as the drain makes it (every entry it does not own adds 0 at
    # a cell of its own), and the same apply of its own entries alone
    g = window.flat()
    own = g.valid & (g.dst_w < b2.w_per_shard)
    mine = own.nonzero()[:, 0]
    view = b2.shard_view(work, 0)
    apply_ms = {
        "whole window": _time_ms(lambda: tpcc.apply_stock_updates(
            view, g.dst_w, g.i_id, g.qty, own, own, restock=False), 10),
        f"its {len(mine)} entries": _time_ms(
            lambda: tpcc.apply_stock_updates(
                view, g.dst_w[mine], g.i_id[mine], g.qty[mine], own[mine],
                own[mine], restock=False), 10)}
    print(f"ring, device time of owner 0's stock apply of the "
          f"{len(own)}-entry window (ms): {json.dumps(apply_ms)}")
    del work, window, s3, e3, r3
    torch.cuda.empty_cache()

    # txn/s in turns: the first round above, then rm3, rm0, none again
    for tag in ("rm3", "rm0", "none"):
        s, e, m, ring, got = run(tag, b2, audit=False)
        if ring_counts(m, ring) != RING_REFERENCE[tag] or got != per_run:
            raise AssertionError(f"ring [{tag}], second run: "
                                 f"{ring_counts(m, ring)} launches {got}")
        tput[tag].append(m.throughput)
        del s, e
    print(f"ring, txn/s (runs in turns none, rm0, rm3, ..., rm3, rm0, none):"
          f" {json.dumps({k: tput[k] for k in ('none', 'rm0', 'rm3')})}")
    return launches, resume_end


# phase 18: crash recovery and self-detecting liveness on phase 17's
# deployment and traffic. (b) A lease monitor whose source stops replica
# LIVE["dead"]'s beats from window LIVE["stop"]: with expiry 0 and
# hysteresis 1 it is declared dead at the third drain, so the refreshes of
# the last two windows reclaim its share
LIVE = dict(expiry=0, hysteresis=1, stop=1, dead=2)
# The JAX package's (committed, aborted, cold rejects, refreshes, ring
# lanes an owner, reserved lanes) and detection lags for that run at this
# width, on the CPU (4 simulated devices, 25 s, 7.3 GB of host memory) by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_liveness.py
LIVE_REFERENCE = ((1330, 6862, 441, 4, [95, 55, 111, 82], 0), [2])
# (c) the reference's two failure rows (benchmarks/paper_figures.py's
# escrow_failures and liveness) through EscrowPodSimulator on this
# deployment, and (d) at their own toy scale: 12 windows, replica 2 killed
# at window 4 and recovered (from the checkpoint taken then) or revived at
# window 8
SIM = {"full": dict(scale=None, windows=12, batch=BATCH // SHARDS,
                    retry_cap=RING_CAP, retry_max=3,
                    hot_items=RING_HOT_ITEMS, seed=SEED,
                    stock_scale={"escrow_failures": 1, "liveness": 1},
                    remote_frac=RING["remote_frac"], item_skew=ITEM_SKEW),
       "toy": dict(scale=(4, 2, 16, 64, 1024, 15), windows=12, batch=16,
                   retry_cap=128, retry_max=3, hot_items=None, seed=11,
                   stock_scale={"escrow_failures": 20, "liveness": 3},
                   remote_frac=0.5, item_skew=1.2)}
SIM_KILLED = 2
# The JAX package's counts for those rows: at full width on the CPU (137 s,
# 13.2 GB of host memory at its peak) by
#   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_failures.py
# and at the toy scale the committed BENCH_escrow_failures.json and
# BENCH_liveness.json
_KILLED = dict(detected_in_windows=3, detection_bound=3, handback_ok=True)
SIM_REFERENCE = {
    ("full", "escrow_failures", False): dict(committed=767, final_rejects=90),
    ("full", "escrow_failures", True): dict(committed=712, final_rejects=74),
    ("full", "liveness", False): dict(committed=767, final_rejects=90,
                                      res_granted=1, res_completed=1),
    ("full", "liveness", True): dict(committed=693, final_rejects=82,
                                     res_granted=0, res_completed=0,
                                     **_KILLED),
    ("toy", "escrow_failures", False): dict(committed=309, final_rejects=42),
    ("toy", "escrow_failures", True): dict(committed=299, final_rejects=34),
    ("toy", "liveness", False): dict(committed=95, final_rejects=32,
                                     res_granted=1, res_completed=1),
    ("toy", "liveness", True): dict(committed=91, final_rejects=27,
                                    res_granted=1, res_completed=1,
                                    **_KILLED),
}


def stop_beat(R, dead, stop):
    """A lease source: every replica beats once a window, but ``dead``'s
    stamp stops advancing at window ``stop``."""
    import numpy as np

    from repro_torch.core.lattice import pack_lease_stamp

    def source(window):
        seq = np.full(R, window + 1, np.int64)
        seq[dead] = min(window, stop - 1) + 1
        return np.asarray(pack_lease_stamp(0, seq), np.int64)
    return source


def _dir_bytes(d) -> int:
    import os
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def disk_resume(scale, resume_end):
    """Phase 18 (a): phase 17's split run through the disk. For B2 and for
    B1 (``effects="scan"``): ``RING_SPLIT`` batches with
    ``final_flush=False``, ``save_run``, ``restore_run(engine)`` bit-equal
    to the saved image, then the resume from the restored image, which
    must end bit-equal to phase 17's in-memory resume (``resume_end``) with
    ``RING_REFERENCE["resume"]``'s counts. A save that dies before its
    commit leaves ``latest_manifest`` on the committed generation. Returns
    each kernel's launches."""
    import tempfile

    import torch

    from repro_torch.ckpt.checkpoint import latest_manifest
    from repro_torch.txn import restore_run, save_run

    launches = dict.fromkeys(("escrow_admit", "txn_megastep"), 0)
    names = tuple(launches)
    split = SHARDS * (RING_SPLIT + 1)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    for kernel, effects, want in (("txn_megastep", "fused", (0, split)),
                                  ("escrow_admit", "scan", (split, 0))):
        eng = ring_engine(scale, "kernel", effects)
        s, e, m, ring, got = ring_run(scale, "noflush", eng,
                                      n_batches=RING_SPLIT)
        if ring_counts(m, ring) != RING_REFERENCE["split"] or got != want:
            raise AssertionError(f"disk resume [{kernel}]: split "
                                 f"{ring_counts(m, ring)} launches {got}")
        for k, n in zip(names, got):
            launches[k] += n
        with tempfile.TemporaryDirectory(dir=build) as d:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            man = save_run(d, s, RING_SPLIT, esc=e, retry=ring)
            save_s = time.perf_counter() - t0
            nbytes = _dir_bytes(d)
            t0 = time.perf_counter()
            rr = restore_run(d, eng)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            bad = _same(s, rr.state) + _same(e, rr.esc) + _same(ring, rr.retry)
            if bad or rr.step != RING_SPLIT or rr.state.s_quantity.device \
                    != s.s_quantity.device:
                raise AssertionError(f"disk resume [{kernel}]: the restore "
                                     f"!= the saved image: {bad}")
            print(f"recovery [{kernel}]: save_run of the {RING_SPLIT}-batch "
                  f"image: {nbytes:,} bytes in {save_s:.3f} s; restore_run "
                  f"onto the card in {restore_s:.3f} s, "
                  f"{nbytes / restore_s / 1e9:.3f} GB/s (host wall time); "
                  f"bit-equal to the saved image")
            del s, e, ring
            if kernel == "txn_megastep":
                # a writer that dies between its shard file and the commit
                save_run(d, rr.state, RING_SPLIT + 1, esc=rr.esc,
                         retry=rr.retry, commit=False)
                latest = latest_manifest(d)
                if (latest.seq_id, latest.step) != (man.seq_id, RING_SPLIT):
                    raise AssertionError(f"recovery: the uncommitted save "
                                         f"shadowed generation {man.seq_id}")
                print(f"recovery: a save that died before its commit leaves "
                      f"latest_manifest on generation {latest.seq_id} "
                      f"(step {latest.step})")
        s, e, m, ring, got = ring_run(
            scale, "noflush", eng, rr.state, rr.esc, n_batches=RING_SPLIT,
            seed=SEED + 1, retry=rr.retry, final_flush=True)
        del rr
        c = ring_counts(m, ring)
        bad = [d for d in (_same(type(x)(*(v.cuda() for v in x)), y)
                           for x, y in zip(resume_end[:3], (s, e, ring)))
               if d]
        if bad or c != RING_REFERENCE["resume"] or c != resume_end[3] \
                or got != want:
            raise AssertionError(f"disk resume [{kernel}]: {bad} {c} "
                                 f"launches {got}")
        print(f"recovery [{kernel}]: the resume from the disk ends bit-equal "
              f"to phase 17's in-memory resume (state, escrow, ring, counts "
              f"{c}); launches={got}")
        for k, n in zip(names, got):
            launches[k] += n
        del s, e, ring
        torch.cuda.empty_cache()
    return launches


def liveness_runs(scale):
    """Phase 18 (b): ``run_loop(liveness=)`` on phase 17's rm3 run. A
    monitor whose source beats every replica is bit-equal to ``alive=None``
    (``RING_REFERENCE["rm3"]``); one whose source stops replica
    ``LIVE["dead"]``'s beats gives the JAX package's counts and detection
    lags (``LIVE_REFERENCE``) and leaves the dead slot no shares. Returns
    the B2 launches."""
    import numpy as np
    import torch

    from repro_torch.core.lattice import pack_lease_stamp
    from repro_torch.runtime.liveness import LeaseMonitor

    R, per_run = SHARDS, SHARDS * (N_BATCHES + 1)
    b2 = ring_engine(scale)
    s0, e0, m0, r0, got0 = ring_run(scale, "rm3", b2)
    beats = LeaseMonitor(R, source=lambda w: np.asarray(
        pack_lease_stamp(0, np.full(R, w + 1)), np.int64))
    s1, e1, m1, r1, got1 = ring_run(scale, "rm3", b2, liveness=beats)
    bad = _same(s0, s1) + _same(e0, e1) + _same(r0, r1)
    c = ring_counts(m1, r1)
    if bad or c != ring_counts(m0, r0) or c != RING_REFERENCE["rm3"] \
            or beats.window != N_BATCHES // MERGE_EVERY or beats.detections \
            or got0 != got1 or got1 != (0, per_run):
        raise AssertionError(f"liveness: an always-beating monitor != "
                             f"alive=None: {bad} {c} {beats.detections} "
                             f"launches {got1}")
    print(f"liveness: a monitor beating every replica, ticked "
          f"{beats.window} times, bit-equal to alive=None (state, escrow, "
          f"ring, counts {c}); launches={got1}")
    del s0, e0, r0, s1, e1, r1
    mon = LeaseMonitor(R, expiry=LIVE["expiry"],
                       hysteresis=LIVE["hysteresis"],
                       source=stop_beat(R, LIVE["dead"], LIVE["stop"]))
    s, e, m, ring, got = ring_run(scale, "rm3", b2, liveness=mon)
    c = (ring_counts(m, ring), mon.detection_lags())
    dead_shares = int(e.shares[LIVE["dead"]].sum())
    if c != LIVE_REFERENCE or dead_shares or got != (0, per_run):
        raise AssertionError(f"liveness: {c}, want the JAX package's "
                             f"{LIVE_REFERENCE}; dead slot {dead_shares} "
                             f"shares; launches {got}")
    print(f"liveness: replica {LIVE['dead']} stops beating at window "
          f"{LIVE['stop']}: detected {mon.detections} (window, replica, "
          f"lag), counts {c[0]}, lags {c[1]} (the JAX package's), the dead "
          f"slot 0 shares, strict audit OK; {m.throughput:,.0f} txn/s; "
          f"launches={got}")
    del s, e, ring
    torch.cuda.empty_cache()
    return got0[1] + got1[1] + got[1]


def sim_row(cfg, row, kill, directory):
    """One failure row through ``EscrowPodSimulator`` on the card: steady,
    or replica ``SIM_KILLED`` killed at window W/3 (``escrow_failures``:
    checkpointed first, recovered at 2W/3; ``liveness``: self-detected,
    revived at 2W/3), then drained to quiescence, the cold ledger checked
    and strictly audited. Returns (its counts, committed txn/s over the
    run, the recover call's seconds, serving steps, B2 launches)."""
    import torch

    from repro_torch.kernels.txn_megastep import txn_megastep_cuda
    from repro_torch.runtime.failures import EscrowPodSimulator
    from repro_torch.txn import TPCCScale
    from repro_torch.txn.audit import check_cold_ledger

    scale = (TPCCScale(*cfg["scale"]) if cfg["scale"]
             else TPCCScale.spec_scale(WAREHOUSES))
    live = row == "liveness"
    sim = EscrowPodSimulator(
        scale, SHARDS, retry_cap=cfg["retry_cap"], retry_max=cfg["retry_max"],
        hot_items=cfg["hot_items"], seed=cfg["seed"],
        stock_scale=cfg["stock_scale"][row], liveness=live, reserve=live)
    W = cfg["windows"]
    txn_megastep_cuda.launches = 0
    serving, detected, recover_s = 0, None, None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(W):
        if kill and t == W // 3:
            if not live:
                sim.checkpoint(directory, step=t)
            sim.kill(SIM_KILLED)
        if kill and t == 2 * W // 3:
            if live:
                sim.revive(SIM_KILLED)
            else:
                t1 = time.perf_counter()
                sim.recover(SIM_KILLED, directory)
                torch.cuda.synchronize()
                recover_s = time.perf_counter() - t1
        serving += sum(sim._serving(r) for r in range(SHARDS))
        sim.step(cfg["batch"], remote_frac=cfg["remote_frac"],
                 item_skew=cfg["item_skew"])
        sim.drain()
        sim.refresh()
        if live and kill and detected is None and not sim.alive[SIM_KILLED]:
            detected = t - W // 3 + 1
    if live:
        sim.quiesce()
    else:
        for _ in range(sim.retry_max + 2):
            sim.drain()
    sim.refresh()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    led = sim.cold_ledger()
    check_cold_ledger(led, quiescent=True)
    sim.audit()
    out = dict(committed=sim.committed, final_rejects=led["final_rejects"])
    if live:
        out.update(res_granted=led["res_granted"],
                   res_completed=led["res_completed"])
        if kill:
            out.update(detected_in_windows=detected,
                       detection_bound=sim.monitor.detection_bound,
                       handback_ok=(sim.owner_of[SIM_KILLED] == SIM_KILLED
                                    and sim.alive[SIM_KILLED]))
    return out, sim.committed / wall, recover_s, serving, \
        txn_megastep_cuda.launches


def sim_rows():
    """Phase 18 (c) and (d): both failure rows, steady and with the kill,
    at full width and at the reference's toy scale, each held to the JAX
    package's counts; every serving replica's step is one txn_megastep
    launch. Returns the B2 launches of all the rows."""
    import tempfile

    import torch

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    launches = 0
    for size in ("full", "toy"):
        for row in ("escrow_failures", "liveness"):
            for kill in (False, True):
                with tempfile.TemporaryDirectory(dir=build) as d:
                    out, tps, recover_s, serving, n = sim_row(
                        SIM[size], row, kill, d)
                torch.cuda.empty_cache()
                want = SIM_REFERENCE[(size, row, kill)]
                tag = f"{row}, {size}, {'kill' if kill else 'steady'}"
                if out != want or n != serving:
                    raise AssertionError(
                        f"pod simulator [{tag}]: {out}, want the JAX "
                        f"package's {want}; txn_megastep launches {n} for "
                        f"{serving} serving steps")
                launches += n
                extra = ("" if recover_s is None
                         else f"; recover {recover_s:.3f} s")
                print(f"pod simulator [{tag}]: {json.dumps(out)} (the JAX "
                      f"package's); exact cold ledger, strict audit OK; "
                      f"{tps:,.1f} committed txn/s{extra}; {serving} serving "
                      f"steps, txn_megastep launches={n}")
    return launches


# phase 19: the fused executor. Phase 4's deployment (R = 1) and phase 16's
# (R = SHARDS), each row's stream through run_loop(fused=True), a chunk of
# MERGE_EVERY batches one CUDA graph replay, and by dispatch, in turns
FUSED_RUNS = 3
STRICT_KERNEL = dict(stock_invariant="strict", admission="kernel")
FUSED_ROWS = {
    "merge New-Order": ({}, {}),
    "merge mix": ({}, MIX),
    "escrow New-Order, txn_megastep": (dict(STRICT_KERNEL, effects="fused"),
                                       {}),
    "escrow New-Order, escrow_admit": (dict(STRICT_KERNEL, effects="scan"),
                                       {}),
    "escrow mix": (dict(STRICT_KERNEL, effects="fused"), MIX),
}
CHUNK_KERNELS = ("escrow_admit", "txn_megastep", "ramp_read")


def _mix_counts(m):
    return (m.neworders, m.aborts, m.cold_rejects, m.refreshes,
            m.anti_entropy_rounds, m.payments, m.order_statuses,
            m.stock_levels, m.deliveries, m.reads_found,
            m.fractures_observed, m.lines_repaired)


def fused_row(scale, R, row, smi, tables):
    """One row of phase 19 on R shards: ``FUSED_RUNS`` fused runs and as
    many by dispatch, in turns, each from the same initial state, every one
    bit-equal to the first (state, escrow, counts), which is audited; each
    run's B1, B2 and B3 launches equal (counted through the replays); the
    device time of one chunk replay and one drain (CUDA events inside the
    last fused run, and queued behind a spin after it) and the graphs'
    pool bytes. ``tables`` is ``init_state(scale, seed=SEED)``, which the
    runs copy. Returns the row's launches by kernel."""
    import statistics

    from repro_torch.txn import assert_audit, run_loop, tpcc
    from repro_torch.txn.engine import Engine
    from repro_torch.txn.executor import KERNELS as kernels
    from repro_torch.txn.executor import get_fused_executor

    ekw, mix = FUSED_ROWS[row]
    escrow = bool(ekw)
    eng = Engine(scale, n_shards=R, **ekw)
    base = tpcc.copy_tree(tables)
    loop = dict(batch_per_shard=BATCH // R, n_batches=N_BATCHES,
                remote_frac=REMOTE_FRAC, merge_every=MERGE_EVERY, seed=SEED,
                **mix)
    if escrow:
        base.s_quantity.mul_(STOCK_MULTIPLIER)
        loop.update(refresh_every=REFRESH_EVERY, item_skew=ITEM_SKEW)
    total = dict.fromkeys(CHUNK_KERNELS, 0)
    tput = {"fused": [], "dispatch": []}
    per_run = {"fused": set(), "dispatch": set()}
    first = None
    for _ in range(FUSED_RUNS):
        for fused in (True, False):
            mode = "fused" if fused else "dispatch"
            for k in kernels:
                k.launches = 0
            s, e, m = run_loop(eng, tpcc.copy_tree(base), fused=fused,
                               **loop)
            got = tuple(k.launches for k in kernels)
            for name, n in zip(CHUNK_KERNELS, got):
                total[name] += n
            per_run[mode].add(got)
            tput[mode].append(m.throughput)
            if first is None:
                rep = (assert_audit(s, escrow=e, initial_stock=base.s_quantity,
                                    strict_stock=True) if escrow
                       else assert_audit(s))
                first = (s, e, _mix_counts(m), rep.describe())
            else:
                bad = _same(s, first[0]) + (_same(e, first[1]) if escrow
                                            else [])
                if bad or _mix_counts(m) != first[2]:
                    raise AssertionError(f"fused [{row}, R={R}]: {mode} run "
                                         f"!= the first fused run: {bad} "
                                         f"{_mix_counts(m)} {first[2]}")
            del s, e
    # B1 with effects "scan", B2 with "fused", B3 with the mix's reads
    want = (escrow and ekw["effects"] == "scan",
            escrow and ekw["effects"] == "fused", bool(mix))
    if len(per_run["fused"]) != 1 or per_run["fused"] != per_run["dispatch"] \
            or tuple(n > 0 for n in next(iter(per_run["fused"]))) != want:
        raise AssertionError(f"fused [{row}, R={R}]: launches {per_run}")
    ex = get_fused_executor(eng, ring_rows=MERGE_EVERY,
                            deliveries=bool(mix))
    run = ex.last_run
    g = run["graphs"][MERGE_EVERY]
    if g.replays != N_BATCHES // MERGE_EVERY or len(run["graphs"]) != 1:
        raise AssertionError(f"fused [{row}, R={R}]: {g.replays} replays")
    st, ring, _, esc = g.live
    drain = ((lambda: ex.drain_refresh(st, ring, esc)) if escrow
             else (lambda: ex.drain(st, ring)))
    launches = next(iter(per_run["fused"]))
    out = dict(
        counts=first[2],
        txn_s=tput, spread={k: [min(v), max(v)] for k, v in tput.items()},
        launches_a_batch={k: n / (N_BATCHES + 1) for k, n in
                          zip(CHUNK_KERNELS, launches)},
        chunk_ms_in_run=statistics.median(run["chunk_ms"]),
        drain_ms_in_run=statistics.median(run["drain_ms"]),
        chunk_ms=_time_ms(g.graph.replay, 3), drain_ms=_time_ms(drain, 3),
        pool_bytes=g.pool_bytes, replays=g.replays,
        captured=dict(g.launches))
    print(f"fused [{row}, R={R}] ({smi}): {json.dumps(out)}; bit-equal "
          f"to dispatch in {2 * FUSED_RUNS} runs in turns; {first[3]}")
    del first, st, ring, esc, g, run, ex, eng, base
    return total


def fused_executor(scale, smi):
    """Phase 19: every row of ``FUSED_ROWS`` on phase 4's deployment and
    on phase 16's ``SHARDS`` shards (:func:`fused_row`); then phase 17's
    ``retry_max=3`` run and phase 18 (b)'s stop-beat run through
    ``fused=True``, held to the JAX package's counts (``RING_REFERENCE``,
    ``LIVE_REFERENCE``), the rm3 run bit-equal to its dispatch run (state,
    escrow; the ring's lanes an owner, gathered in another order). Returns
    each kernel's launches."""
    import torch

    from repro_torch.runtime.liveness import LeaseMonitor
    from repro_torch.txn import init_state

    launches = dict.fromkeys(CHUNK_KERNELS, 0)
    tables = init_state(scale, seed=SEED)
    for R in (1, SHARDS):
        for row in FUSED_ROWS:
            t0 = time.perf_counter()
            for k, n in fused_row(scale, R, row, smi, tables).items():
                launches[k] += n
            torch.cuda.empty_cache()
            print(f"fused [{row}, R={R}]: {time.perf_counter() - t0:.1f} s")
    del tables
    b2 = ring_engine(scale)
    per_run = (0, SHARDS * (N_BATCHES + 1))
    s, e, m, ring, got = ring_run(scale, "rm3", b2, fused=True)
    sd, ed, md, rd, gotd = ring_run(scale, "rm3", b2, audit=False)
    lanes = lambda r: [sorted(zip(*(x[o][r.valid[o]].tolist()  # noqa: E731
                                    for x in r))) for o in range(SHARDS)]
    bad = _same(s, sd) + _same(e, ed)
    c = ring_counts(m, ring)
    if bad or lanes(ring) != lanes(rd) or c != RING_REFERENCE["rm3"] \
            or got != per_run or gotd != per_run:
        raise AssertionError(f"fused ring [rm3]: {bad} {c} launches {got}")
    print(f"fused ring [rm3]: counts {c} (the JAX package's), bit-equal to "
          f"dispatch (state, escrow; the ring's lanes an owner); "
          f"{m.throughput:,.0f} txn/s fused, {md.throughput:,.0f} by "
          f"dispatch; launches={got}")
    del s, e, ring, sd, ed, rd
    mon = LeaseMonitor(SHARDS, expiry=LIVE["expiry"],
                       hysteresis=LIVE["hysteresis"],
                       source=stop_beat(SHARDS, LIVE["dead"], LIVE["stop"]))
    s, e, m, ring, got2 = ring_run(scale, "rm3", b2, liveness=mon,
                                   fused=True)
    c = (ring_counts(m, ring), mon.detection_lags())
    dead = int(e.shares[LIVE["dead"]].sum())
    if c != LIVE_REFERENCE or dead or got2 != per_run:
        raise AssertionError(f"fused liveness: {c} dead slot {dead} "
                             f"launches {got2}")
    print(f"fused liveness: replica {LIVE['dead']} stops beating: counts "
          f"{c[0]}, lags {c[1]} (the JAX package's), the dead slot 0 "
          f"shares; {m.throughput:,.0f} txn/s; launches={got2}")
    del s, e, ring
    torch.cuda.empty_cache()
    for n in (got, gotd, got2):
        launches["escrow_admit"] += n[0]
        launches["txn_megastep"] += n[1]
    return launches


# phase 20: the observability plane. Phase 19's merge mix and escrow mix
# (txn_megastep) rows on phase 4's deployment and phase 16's, each run with
# ObsSession(metrics=True, trace=True) and without a session, in turns
OBS_RUNS = 3
OBS_ROWS = ("merge mix", "escrow mix")
# the JAX package's snapshots of these runs (``obs_digest``), printed by
# ``python tests/test_torch_obs.py``
OBS_REFERENCE = {
    'merge mix/R1': {
        "latency": {
            'neworder': [8192, 2.0, 16.0],
            'payment': [8192, 2.0, 2.0],
            'order_status': [2048, 2.0, 2.0],
            'stock_level': [2048, 2.0, 2.0],
            'delivery': [8098, 2.0, 2.0],
        },
        "aborts": [0],
        "cold_rejects": [0],
        "item_access": [
            81631,
            [6, 6, 6, 6, 6, 6, 6, 6, 6, 6],
            []],
        "digest": {
            'latency':
                'cac15f31c9d1b3ee7aeed45a8be74aa4'
                '2c6981966c9b8c33cafe604196d81505',
            'item_access':
                'bdac56555ceb4609b78f9ab001f81e6b'
                '43f7aff4bab01d99dbd8983eb123758c',
        },
        "ledger": [4128, 0, 96.74418604651163, [
            ['megastep (hot scan)', True, {}, 0, 1.0],
            ['metrics record', True, {}, 0, 1.0],
            ['metrics counter fold', True, {}, 0, 0.0],
            ['order-status read', True, {}, 0, 0.0],
            ['stock-level read', True, {}, 0, 0.0],
            ['anti-entropy drain', False, {'all-gather': 4}, 399360, 1.0],
        ]],
    },
    'escrow mix/R1': {
        "latency": {
            'neworder': [5610, 2.0, 16.0],
            'payment': [8192, 2.0, 2.0],
            'order_status': [2048, 2.0, 2.0],
            'stock_level': [2048, 2.0, 2.0],
            'delivery': [5598, 2.0, 2.0],
        },
        "aborts": [2582],
        "cold_rejects": [0],
        "item_access": [
            82514,
            [16213, 6987, 4185, 3122, 2270, 1839, 1614, 1426, 1156, 1075],
            [0, 1, 2, 3, 4, 5, 6, 7, 8]],
        "digest": {
            'latency':
                'bc835660d60646b3d4cc15e048895147'
                '1451cbe9df6ce95de0cfe7fc4415e05b',
            'item_access':
                '6dfa8b977b338a002824cc2030728102'
                '9f4773a70e5097a93e3cd56ff6fc18ed',
        },
        "ledger": [4128, 0, 158.75968992248062, [
            ['megastep (hot scan)', True, {}, 0, 1.0],
            ['metrics record', True, {}, 0, 1.0],
            ['metrics counter fold', True, {}, 0, 0.0],
            ['order-status read', True, {}, 0, 0.0],
            ['stock-level read', True, {}, 0, 0.0],
            ['strict drain', False, {'all-gather': 4}, 399360, 0.0],
            ['drain + share refresh', False,
             {'all-gather': 4, 'all-reduce': 1}, 655360, 1.0],
        ]],
    },
    'merge mix/R4': {
        "latency": {
            'neworder': [8192, 2.0, 16.0],
            'payment': [8192, 2.0, 2.0],
            'order_status': [2048, 2.0, 2.0],
            'stock_level': [2048, 2.0, 2.0],
            'delivery': [8102, 2.0, 2.0],
        },
        "aborts": [0, 0, 0, 0],
        "cold_rejects": [0, 0, 0, 0],
        "item_access": [
            81547,
            [7, 7, 7, 6, 6, 6, 6, 6, 6, 6],
            [18708, 40966, 93086]],
        "digest": {
            'latency':
                '878216543bcfd7f738506c75e4380a13'
                'b068675fdf54692ff753e0c7e380a2fa',
            'item_access':
                '689c88139573bb08737a97dd9e5d081f'
                '6f67a4cc00c4f9a332eef0e7cdede8d1',
        },
        "ledger": [4224, 0, 94.54545454545455, [
            ['megastep (hot scan)', True, {}, 0, 1.0],
            ['metrics record', True, {}, 0, 1.0],
            ['metrics counter fold', True, {}, 0, 0.0],
            ['order-status read', True, {}, 0, 0.0],
            ['stock-level read', True, {}, 0, 0.0],
            ['anti-entropy drain', False, {'all-gather': 4}, 399360, 1.0],
        ]],
    },
    'escrow mix/R4': {
        "latency": {
            'neworder': [4690, 2.0, 16.0],
            'payment': [8192, 2.0, 2.0],
            'order_status': [2048, 2.0, 2.0],
            'stock_level': [2048, 2.0, 2.0],
            'delivery': [4688, 2.0, 2.0],
        },
        "aborts": [747, 1002, 788, 965],
        "cold_rejects": [0, 0, 0, 0],
        "item_access": [
            81512,
            [15943, 7032, 4117, 3106, 2262, 1856, 1576, 1347, 1164, 1058],
            [0, 1, 2, 3, 4, 5, 6, 7, 8]],
        "digest": {
            'latency':
                '5abe080db2c84852b5b0dc2876fc0b26'
                '606831ad437f20c0477ca49469b56225',
            'item_access':
                '4fa51192d4dce33f2ebb0fff74167846'
                'cf7ef43e675e8bf7ae20e8e20212cad2',
        },
        "ledger": [4224, 0, 155.15151515151516, [
            ['megastep (hot scan)', True, {}, 0, 1.0],
            ['metrics record', True, {}, 0, 1.0],
            ['metrics counter fold', True, {}, 0, 0.0],
            ['order-status read', True, {}, 0, 0.0],
            ['stock-level read', True, {}, 0, 0.0],
            ['strict drain', False, {'all-gather': 4}, 399360, 0.0],
            ['drain + share refresh', False,
             {'all-gather': 4, 'all-reduce': 1}, 655360, 1.0],
        ]],
    },
}


def lattice_digest(metrics) -> dict:
    """sha256 of the host copy's latency counts and item-access slots
    (int32 bytes), as ``tests/test_torch_obs.py``'s reference script takes
    them."""
    import hashlib

    import numpy as np
    return {k: hashlib.sha256(np.asarray(x, np.int32).tobytes()).hexdigest()
            for k, x in (("latency", metrics.latency.counts),
                         ("item_access", metrics.item_access.slots))}


def obs_digest(snap) -> dict:
    """The fields of an observability snapshot that phase 20 holds to the
    JAX package's: per-type latency count, p50 and p99 steps; the
    per-replica abort and cold-reject counters; the item demand's total,
    its top-10 counts and the items above the tenth count (which of the
    items tied at the tenth count are listed is numpy's sort order, not
    the port's); the lattice digests; the ledger's chunk size, hot
    collectives, bytes a transaction and phases."""
    top = snap["item_access"]["top_items"]
    tenth = top[-1]["accesses"] if top else 0
    led = snap["ledger"]
    return {
        "latency": {t: [r["count"], r["p50_steps"], r["p99_steps"]]
                    for t, r in snap["latency"].items()},
        "aborts": snap["counters"]["aborts_per_replica"],
        "cold_rejects": snap["counters"]["cold_rejects_per_replica"],
        "item_access": [snap["item_access"]["total_line_demand"],
                        [x["accesses"] for x in top],
                        sorted(x["i_id"] for x in top
                               if x["accesses"] > tenth)],
        "digest": snap["digest"],
        "ledger": [led["txns_per_chunk"], led["hot_collectives"],
                   led["bytes_per_txn"],
                   [[q["phase"], q["hot"], q["collectives"],
                     q["bytes_per_call"], q["calls_per_chunk"]]
                    for q in led["phases"]]],
    }


def _exact(snap) -> dict:
    """A snapshot's latency, counters and item access without the fields
    derived from wall time."""
    lat = {t: {k: r[k] for k in ("count", "p50_steps", "p99_steps")}
           for t, r in snap["latency"].items()}
    return dict(latency=lat, counters=snap["counters"],
                item_access=snap["item_access"])


def obs_row(scale, R, row, smi, tables):
    """One row of phase 20 on R shards: ``OBS_RUNS`` runs with metrics and
    as many without, in turns, from the same tables: every run bit-equal to
    the first (state, escrow, counts), the metrics-on snapshots equal; B1,
    B2 and B3 launches equal with metrics on and off, and in the merge
    regime each graph's captured launches and pool bytes; txn/s both ways
    and ``metrics_on_vs_off`` as the reference's ``obs_overhead`` row takes
    it. Then one run with ``sync_spans=True`` and the ledger: its snapshot
    is held to ``OBS_REFERENCE`` and cross-checked against the run's
    stats, its span shares printed beside the executor's CUDA-event chunk
    and drain times. Returns the row's launches by kernel (the ledger's
    proof runs launch B2 and B3 too)."""
    import statistics

    from repro_torch.obs import ObsSession
    from repro_torch.txn import run_loop, tpcc
    from repro_torch.txn.engine import Engine
    from repro_torch.txn.executor import KERNELS as kernels
    from repro_torch.txn.executor import get_fused_executor

    ekw, mix = FUSED_ROWS[row]
    escrow = bool(ekw)
    eng = Engine(scale, n_shards=R, **ekw)
    ex = get_fused_executor(eng, ring_rows=MERGE_EVERY, deliveries=True)
    base = tpcc.copy_tree(tables)
    loop = dict(batch_per_shard=BATCH // R, n_batches=N_BATCHES,
                remote_frac=REMOTE_FRAC, merge_every=MERGE_EVERY, seed=SEED,
                **mix)
    if escrow:
        base.s_quantity.mul_(STOCK_MULTIPLIER)
        loop.update(refresh_every=REFRESH_EVERY, item_skew=ITEM_SKEW)
    total = dict.fromkeys(CHUNK_KERNELS, 0)
    tput = {"on": [], "off": []}
    launches = {"on": set(), "off": set()}
    graphs = {"on": [], "off": []}
    first = snap = None
    for _ in range(OBS_RUNS):
        for mode in ("on", "off"):
            for k in kernels:
                k.launches = 0
            obs = ObsSession(metrics=True, trace=True) if mode == "on" \
                else None
            s, e, m = run_loop(eng, tpcc.copy_tree(base), obs=obs, **loop)
            got = tuple(k.launches for k in kernels)
            for name, n in zip(CHUNK_KERNELS, got):
                total[name] += n
            launches[mode].add(got)
            tput[mode].append(m.throughput)
            graphs[mode].append({T: (dict(g.launches), g.pool_bytes)
                                 for T, g in ex.last_run["graphs"].items()})
            if first is None:
                first = (s, e, _mix_counts(m))
            else:
                bad = _same(s, first[0]) + (_same(e, first[1]) if escrow
                                            else [])
                if bad or _mix_counts(m) != first[2]:
                    raise AssertionError(f"obs [{row}, R={R}]: metrics "
                                         f"{mode} run != the first: {bad} "
                                         f"{_mix_counts(m)} {first[2]}")
            if obs is not None:
                if snap is None:
                    snap = obs.snapshot()
                elif _exact(obs.snapshot()) != _exact(snap):
                    raise AssertionError(f"obs [{row}, R={R}]: snapshots of "
                                         f"two metrics-on runs differ")
            del s, e
    # B2 in the escrow row, B3 in both (the mix's reads), B1 in neither
    if len(launches["on"]) != 1 or launches["on"] != launches["off"] \
            or tuple(n > 0 for n in next(iter(launches["on"]))) != (
                False, escrow, True):
        raise AssertionError(f"obs [{row}, R={R}]: launches {launches}")
    captured = {mode: [{T: g[0] for T, g in run.items()} for run in runs]
                for mode, runs in graphs.items()}
    if any(c != captured["off"][0] for runs in captured.values()
           for c in runs):
        raise AssertionError(f"obs [{row}, R={R}]: captured launches "
                             f"{captured}")
    if not escrow and any(run != graphs["off"][0] for runs in graphs.values()
                          for run in runs):
        raise AssertionError(f"obs [{row}, R={R}]: merge-regime graphs "
                             f"differ with metrics on and off: {graphs}")
    # (b) and (c): one run with the ledger and device-synced spans; its
    # snapshot against the JAX package's and against the stats
    for k in kernels:
        k.launches = 0
    obs = ObsSession(metrics=True, trace=True, sync_spans=True, ledger=True)
    s, e, m = run_loop(eng, tpcc.copy_tree(base), obs=obs, **loop)
    for name, k in zip(CHUNK_KERNELS, kernels):
        total[name] += k.launches
    bad = _same(s, first[0]) + (_same(e, first[1]) if escrow else [])
    if bad or _mix_counts(m) != first[2] or \
            _exact(obs.snapshot()) != _exact(snap):
        raise AssertionError(f"obs [{row}, R={R}]: the synced run differs: "
                             f"{bad}")
    del s, e
    snap = obs.snapshot()
    key = f"{row}/R{R}"
    got = obs_digest(dict(snap, digest=lattice_digest(obs.metrics)))
    if got != OBS_REFERENCE[key]:
        raise AssertionError(f"obs [{key}]: snapshot != the JAX package's: "
                             f"{json.dumps(got)}")
    lat = snap["latency"]
    if (snap["ledger"]["hot_collectives"] != 0
            or lat["neworder"]["count"] != m.neworders
            or sum(snap["counters"]["aborts_per_replica"]) != m.aborts
            or sum(snap["counters"]["cold_rejects_per_replica"])
            != m.cold_rejects):
        raise AssertionError(f"obs [{key}]: snapshot against stats: "
                             f"{lat['neworder']} {snap['counters']} {m}")
    spans = snap["spans"]["phases"]
    best = {k: max(v) for k, v in tput.items()}
    out = dict(
        txn_s=tput, spread={k: [min(v), max(v)] for k, v in tput.items()},
        metrics_on_vs_off=min(best["on"] / best["off"], 1.0),
        measured_ratio=best["on"] / best["off"],
        launches=dict(zip(CHUNK_KERNELS, next(iter(launches["on"])))),
        pool_bytes={mode: runs[0][MERGE_EVERY][1]
                    for mode, runs in graphs.items()},
        synced_spans={p: dict(count=v["count"], total_ms=v["total_s"] * 1e3,
                              share=v["share"]) for p, v in spans.items()},
        chunk_ms=statistics.median(ex.last_run["chunk_ms"]),
        drain_ms=statistics.median(ex.last_run["drain_ms"]),
        step_wall_s=snap["step_wall_s"],
        neworder_steps=[lat["neworder"]["p50_steps"],
                        lat["neworder"]["p99_steps"]],
        bytes_per_txn=snap["ledger"]["bytes_per_txn"])
    print(f"obs [{row}, R={R}] ({smi}): {json.dumps(out)}; bit-equal with "
          f"metrics on and off in {2 * OBS_RUNS} runs in turns; snapshot "
          f"== the JAX package's, hot collectives 0")
    return total


def serving_driver():
    """Phase 20 (d): ``python -m repro_torch.launch.tpcc_serve --batches
    8`` on the card; its dashboard prints and its ``--json`` snapshot
    parses with no hot collective."""
    root = Path(__file__).resolve().parent
    path = root / "build" / "tpcc_serve_snapshot.json"
    path.parent.mkdir(exist_ok=True)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tpcc_serve", "--batches",
         "8", "--json", str(path)], cwd=root, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=str(root / "src")))
    if proc.returncode != 0:
        raise AssertionError(f"tpcc_serve: exit {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    text = proc.stdout
    lo = text.index("-- observability plane")
    hi = text.index("-- coordinated (2PC-style)")
    print("tpcc_serve:\n" + text[lo:hi].rstrip())
    snap = json.loads(path.read_text())
    if snap["schema"] != "repro.obs/1" or \
            snap["ledger"]["hot_collectives"] != 0:
        raise AssertionError(f"tpcc_serve snapshot: {snap.get('ledger')}")
    tail = [line for line in text.splitlines() if "speedup" in line]
    print(f"tpcc_serve: snapshot parses, hot collectives 0; {tail}")


def observability(scale, smi):
    """Phase 20: ``obs_row`` for each of ``OBS_ROWS`` on phase 4's
    deployment and phase 16's ``SHARDS`` shards, then the serving driver.
    Returns each kernel's launches."""
    import torch

    from repro_torch.txn import init_state

    launches = dict.fromkeys(CHUNK_KERNELS, 0)
    tables = init_state(scale, seed=SEED)
    for R in (1, SHARDS):
        for row in OBS_ROWS:
            t0 = time.perf_counter()
            for k, n in obs_row(scale, R, row, smi, tables).items():
                launches[k] += n
            torch.cuda.empty_cache()
            print(f"obs [{row}, R={R}]: {time.perf_counter() - t0:.1f} s")
    del tables
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serving_driver()
    print(f"tpcc_serve: {time.perf_counter() - t0:.1f} s")
    return launches


# phase 21: the moe, hybrid, vlm and audio families served at their
# published widths and depths through the launcher, as phases 11-12 serve
# theirs. These families teacher-force the prompt prefix one eager decode
# step a token, as the reference Server does, so prompts stay within 128
# tokens. One model is on the card at a time.
FAMILY_FLAGS = ["--requests", str(SERVE_REQUESTS), "--batch", str(SERVE_BATCH),
                "--prompt-len", "128", "--new-tokens", str(NEW_TOKENS)]
FAMILY_CAPACITY = {"whisper-tiny": 448}   # its text context; others 2048
TC128 = "flash_attention_tc_kernelILi128E"   # the hd-128 tensor-core kernel


def ptxas_lines(log: str, entry: str) -> list[str]:
    """The ``-Xptxas -v`` lines (registers, stack, spills) of the entry
    functions whose mangled name holds ``entry``."""
    lines, mine = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or \
                "Function properties for" in line:
            mine = entry in line
        elif mine and ("Used" in line or "spill" in line):
            lines.append(line.split(":", 1)[-1].strip())
    return lines


def family_problems(arch, out):
    """B5's problems on a family's main path, from the served model:
    (a) olmoe-1b-7b's prefill of batch 1's padded prefix (layer 0), (b)
    whisper-tiny's encoder on a batch's zero frames (layer 0). Returns
    [(tag, q, k, v, causal)]."""
    import torch

    from repro_torch.models import layers, transformer, whisper

    if arch == "olmoe-1b-7b":
        params, cfg, prefix = first_prefill(out)
        x = layers.embed(params, prefix, cfg)
        q, k, v = transformer.qkv(params.layers[0], x, cfg, torch.arange(
            prefix.shape[1], device="cuda"))
        return [("(a) olmoe-1b-7b prefill, layer 0 of batch 1", q, k, v,
                 True)]
    if arch == "whisper-tiny":
        srv = out["server"]
        cfg, lp = srv.model_cfg, srv.params.enc_layers[0]
        frames = torch.zeros(SERVE_BATCH, cfg.n_frames, cfg.d_model,
                             dtype=torch.bfloat16, device="cuda")
        x = frames + whisper.sinusoid(cfg.n_frames, cfg.d_model,
                                      "cuda")[None].to(frames.dtype)
        q, k, v = transformer.rotated_qkv(
            lp.attn, layers.layernorm(lp.attn_norm, x, cfg.norm_eps), cfg,
            torch.arange(cfg.n_frames, device="cuda"))
        return [("(b) whisper-tiny encoder, layer 0 of a batch", q, k, v,
                 False)]
    return []


def moe_prefill(out) -> int:
    """``registry.make_prefill_fn`` for olmoe-1b-7b on batch 1's padded
    prefix, B5's launch count from 0; checks one launch a layer and finite
    logits. Returns the launches."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    params, cfg, prefix = first_prefill(out)
    flash_attention_cuda.launches = 0
    t0 = time.perf_counter()
    lg, cache = registry.make_prefill_fn(cfg, 2048)(params,
                                                    {"tokens": prefix})
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = flash_attention_cuda.launches
    print(f"prefill [{cfg.name}, make_prefill_fn]: B={prefix.shape[0]} "
          f"S={prefix.shape[1]} in {dt * 1e3:.1f} ms (first call); "
          f"flash_attention launches={n}")
    if n != cfg.n_layers or cache.pos != prefix.shape[1] or \
            not bool(torch.isfinite(lg[:, :cfg.vocab]).all()):
        raise AssertionError(f"{cfg.name}: the prefill did not run B5 once "
                             f"a layer, or its logits are not finite")
    return n


def serve_families(build_logs):
    """Phase 21: each of ``FAMILIES`` at full size through the launcher,
    B5's launch count from 0 (the audio family's encoder once a layer a
    batch, none for the others, every launch on the tensor-core route);
    olmoe-1b-7b's ``make_prefill_fn`` (one launch a layer); B5 held to its
    plain version and timed on problems (a) and (b). Returns (launches,
    the problems' rows)."""
    import gc

    import torch

    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.launch import serve as launch

    print(f"ptxas [{TC128}]: " + (" | ".join(ptxas_lines(
        build_logs["flash_attention"], TC128)) or "cached build, no log"))
    routes = flash_attention_cuda.route_launches
    launches, rows = 0, []
    for arch in FAMILIES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        flash_attention_cuda.launches = 0
        for key in routes:
            routes[key] = 0
        t0 = time.perf_counter()
        out = launch.run(["--arch", arch, *FAMILY_FLAGS, "--capacity",
                          str(FAMILY_CAPACITY.get(arch, 2048))])
        torch.cuda.synchronize()
        n = flash_attention_cuda.launches
        srv = out["server"]
        cfg = srv.model_cfg
        gen = [t for r in out["requests"] for t in r.generated]
        tm = srv.timings
        prefill_ms = sum(t.prefill_s for t in tm) * 1e3
        decode_ms = sum(t.decode_s for t in tm) * 1e3
        print(f"serving [{arch}]: {out['n_params']:,} parameters, "
              f"max_memory_allocated "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; "
              f"{out['served']} requests, {out['tok_s']:.1f} tok/s; prefill "
              f"ms per batch {[round(t.prefill_s * 1e3, 3) for t in tm]} at "
              f"prefixes {[t.prefix for t in tm]} "
              f"({prefill_ms / max(sum(t.prefix for t in tm), 1):.3f} ms a "
              f"prefix token); decode "
              f"{decode_ms / sum(t.steps for t in tm):.3f} ms a token; "
              f"flash_attention launches={n} {routes}; "
              f"{time.perf_counter() - t0:.1f} s")
        if out["served"] != SERVE_REQUESTS or out["shed"] or \
                len(gen) != SERVE_REQUESTS * NEW_TOKENS or \
                not all(0 <= t < cfg.vocab for t in gen):
            raise AssertionError(f"{arch}: the server did not serve every "
                                 f"request its {NEW_TOKENS} in-vocabulary "
                                 f"tokens")
        want = cfg.enc_layers * len(tm) if cfg.family == "audio" else 0
        if n != want or routes["tensor_core"] != n:
            raise AssertionError(f"{arch}: {n} launches of flash_attention "
                                 f"{routes}, want {want}, all tensor-core")
        launches += n
        if arch == "olmoe-1b-7b":
            launches += moe_prefill(out)
        for tag, q, k, v, causal in family_problems(arch, out):
            err = attention_parity(tag, q, k, v, causal)
            row = dict(problem=tag, max_abs_err=err,
                       **attention_row(q, k, v, causal))
            print(f"timing [flash_attention, {tag}] {json.dumps(row)}")
            rows.append(row)
            del q, k, v
        del out, srv
    gc.collect()
    torch.cuda.empty_cache()
    return launches, rows


# phase 22: training on the card. smollm-360m at its published width and
# depth (HF HuggingFaceTB/SmolLM-360M), random weights from SEED, bf16
# compute on float32 masters, remat on, AdamW with escrow clipping.
TRAIN_ARCH = "smollm-360m"
TRAIN_BATCH = 8
TRAIN_SEQ = 512
TRAIN_STEPS = 20          # (b) and (d): steps from the pipeline
TRAIN_LOG = 5             # (b): log-boundary reads
FIXED_STEPS = 12          # (b): one fixed batch, the loss must fall
POD_STEPS = 12            # (c): 2 pods, hierarchical, int8
POD_MERGE = 4
CKPT_AT = 10              # (d): checkpoint, then restart to TRAIN_STEPS
TRAIN_FAMILIES = ("smollm-360m", "olmoe-1b-7b", "rwkv6-3b", "hymba-1.5b",
                  "llama-3.2-vision-11b", "whisper-tiny")
TRAIN_TOL = 1e-4          # (a): card vs CPU, float32: loss, gradients
TRAIN_TOL_BF16_LOSS = 2 ** -8   # (a), bf16: the loss, relative (bf16's u)
TRAIN_TOL_BF16 = 2 ** -5        # (a), bf16: gradients norm-wise (8 u)


def _train_opt(**kw):
    from repro_torch.optim import adamw
    return adamw.AdamWConfig(**{**dict(lr=3e-4, warmup_steps=2,
                                       total_steps=TRAIN_STEPS), **kw})


def _state_to(state, device):
    from repro_torch.core import tree as T
    return T.map(lambda x: x.to(device), state)


def _state_err(a, b) -> float:
    from repro_torch.core import tree as T
    return _max_abs_err(T.leaves(_state_to(a, "cpu")),
                        T.leaves(_state_to(b, "cpu")))


def _pod_divergence(state) -> float:
    """Max distance between the two pods' parameters (a deferred state's
    leaves carry the pods on their leading dim)."""
    from repro_torch.core import tree as T
    return max(float((x[0].float() - x[1].float()).abs().max())
               for x in T.leaves(state.params))


@contextlib.contextmanager
def _deterministic():
    """``torch.use_deterministic_algorithms(True)`` (with the cuBLAS
    workspace setting it asks for) inside the block: the embedding's
    backward otherwise adds with atomics, in an order that varies."""
    import torch

    saved = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        if saved is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = saved


def _norm_err(got, want) -> float:
    """||got - want|| / ||want|| over all the leaves of two trees, in
    float64."""
    from repro_torch.core import tree as T
    num = den = 0.0
    for x, y in zip(T.leaves(got), T.leaves(want)):
        x, y = x.detach().cpu().double(), y.detach().cpu().double()
        num += float(((x - y) ** 2).sum())
        den += float((y ** 2).sum())
    return (num / den) ** 0.5


def train_families_card_against_cpu(smi):
    """Phase 22 (a): each family reduced, one sync step on the card against
    the same step on the CPU, from the same parameters and batch
    (``make_train_batch`` on a seeded CPU generator; the vlm's image and
    the audio family's frames included), under deterministic algorithms.

    Float32: the loss within ``TRAIN_TOL`` relative; every gradient leaf
    within ``TRAIN_TOL`` of the leaf's largest CPU value (and 1e-7); and
    the card's updated state, params and both moments, within 1e-6 of the
    CPU's AdamW applied to the card's gradients. The card's state against
    the CPU's own step is printed, not held: Adam's first step divides
    each gradient by its magnitude plus 1e-8, so an element whose gradient
    is float roundoff on both devices moves by up to the learning rate
    either way.

    bf16 compute on the float32 masters (the configuration's ``dtype``
    ``bfloat16``, the same parameters and batch, its floats rounded to
    bf16), as (b)-(d) train: the loss within ``TRAIN_TOL_BF16_LOSS``
    relative; the gradient tree within ``TRAIN_TOL_BF16`` of the CPU's
    (norm-wise, ``_norm_err``); the card's gradients nearer the CPU's
    bf16 gradients than the CPU's float32 ones, so a step that ran in
    another dtype, or left a cast out, fails; the update as in float32."""
    import dataclasses

    import torch

    from repro_torch.configs import registry
    from repro_torch.core import tree as T
    from repro_torch.optim import adamw, coord

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    opt = _train_opt(lr=1e-3, warmup_steps=1)
    for arch in TRAIN_FAMILIES:
        base = registry.get_config(arch).reduced()
        batch32 = registry.make_train_batch(
            torch.Generator().manual_seed(SEED), base, 4, 32)
        grads32 = None
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, dtype=dtype)
            loss_fn = registry.make_loss_fn(cfg)
            setups = {dev: coord.build(cfg, coord.CoordConfig(), opt,
                                       registry.make_loss_fn, device=dev)
                      for dev in ("cpu", "cuda")}
            state = setups["cpu"].init_fn(SEED)
            on_card = _state_to(state, "cuda")
            batch = {k: v.to(getattr(torch, dtype)) if v.is_floating_point()
                     else v for k, v in batch32.items()}
            with _deterministic():
                want = setups["cpu"].step_fn(state, batch)
                got = setups["cuda"].step_fn(on_card, batch)
                loss, grads = coord.value_and_grad(loss_fn, state.params,
                                                   batch)
                card_loss, card_grads = coord.value_and_grad(
                    loss_fn, on_card.params, _state_to(batch, "cuda"))
            loss_err = abs(float(card_loss) - float(loss)) / abs(float(loss))
            grad_err = max(
                float((a.cpu() - b).abs().max())
                / (float(b.abs().max()) + 1e-7)
                for a, b in zip(T.leaves(card_grads), T.leaves(grads)))
            norm_err = _norm_err(card_grads, grads)
            replay = adamw.update(dataclasses.replace(opt, num_replicas=1),
                                  _state_to(card_grads, "cpu"), state.opt,
                                  state.params)
            update_err = _max_abs_err(
                T.leaves(_state_to((got.params, got.opt.mu, got.opt.nu),
                                   "cpu")),
                T.leaves((replay[0], replay[1].mu, replay[1].nu)))
            step_err = _state_err(got, want)
            same_loss = torch.equal(got.loss_slots, card_loss.reshape(1))
            line = (f"training, card vs CPU [{arch}, reduced, {dtype}]: loss "
                    f"{float(loss):.6f}, relative err {loss_err:.3g}; "
                    f"gradients' err {grad_err:.3g} of each leaf's largest, "
                    f"{norm_err:.3g} norm-wise")
            if grads32 is None:
                grads32 = grads
                ok = (loss_err <= TRAIN_TOL and grad_err <= TRAIN_TOL)
            else:
                to32 = _norm_err(card_grads, grads32)
                cpu_gap = _norm_err(grads, grads32)
                line += (f", {to32:.3g} from the CPU's float32 gradients "
                         f"(the CPU's bf16 {cpu_gap:.3g} from them)")
                ok = (loss_err <= TRAIN_TOL_BF16_LOSS
                      and norm_err <= TRAIN_TOL_BF16 and norm_err < to32)
            print(f"{line}; card step vs AdamW on the CPU from the card's "
                  f"gradients max_abs_err {update_err:.3g}; card step vs "
                  f"CPU step max_abs_err {step_err:.3g} (not held); {smi}")
            if not (ok and update_err <= 1e-6 and same_loss):
                raise AssertionError(f"training [{arch}, {dtype}]: the "
                                     f"card's step differs from the CPU's")


def train_full_width(smi):
    """Phase 22 (b): smollm-360m at full width through ``train.run`` (sync,
    ``TRAIN_STEPS`` pipeline steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ``):
    tokens/s and ``max_memory_allocated``, the loss finite, the mean loss
    of the first and of the last ``TRAIN_LOG`` steps; then
    ``FIXED_STEPS`` steps on one fixed batch through ``coord.build``, each
    timed by CUDA events (the step ms), whose loss must fall."""
    import math
    import statistics

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.optim import coord
    from repro_torch.runtime import train

    cfg = registry.get_config(TRAIN_ARCH)
    n_params = registry.exact_param_count(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tc = train.TrainConfig(steps=TRAIN_STEPS, log_every=TRAIN_LOG,
                           seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                           seed=SEED, remat=True, opt=_train_opt())
    state, summary = train.run(cfg, tc)
    peak = torch.cuda.max_memory_allocated()
    hist = summary["history"]
    means = [h["loss_mean"] * h["step"] for h in hist]
    first = means[0] / TRAIN_LOG
    last = (means[-1] - means[-2]) / TRAIN_LOG
    tok_s = summary["tokens"] / summary["wall_seconds"]
    print(f"training [{TRAIN_ARCH}, sync, {n_params:,} parameters, bf16 on "
          f"float32 masters, remat, escrow clip]: {summary['step']} steps of "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens in "
          f"{summary['wall_seconds']:.3f} s, {tok_s:,.0f} tokens/s; "
          f"max_memory_allocated {peak / 1e9:.3f} GB; mean loss of steps "
          f"1-{TRAIN_LOG} {first:.4f}, of the last {TRAIN_LOG} {last:.4f}; "
          f"grad_norm_last {summary['grad_norm_last']:.4f}; {smi}")
    if summary["step"] != TRAIN_STEPS or not all(
            math.isfinite(m) for m in means) or summary["tokens"] != \
            TRAIN_STEPS * TRAIN_BATCH * TRAIN_SEQ:
        raise AssertionError("training: the run did not take its steps "
                             "with a finite loss")
    del state

    setup = coord.build(cfg, coord.CoordConfig(),
                        _train_opt(lr=1e-3, total_steps=50),
                        registry.make_loss_fn)
    batch = Pipeline(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, SEED),
                     cfg).next_batch()
    state = setup.init_fn(SEED)
    slots, events = [], []
    for _ in range(FIXED_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state = setup.step_fn(state, batch)
        ev[1].record()
        events.append(ev)
        slots.append(state.loss_slots.clone())
    torch.cuda.synchronize()
    cum = [0.0] + [float(x[0]) for x in slots]
    losses = [b - a for a, b in zip(cum, cum[1:])]
    step_ms = [a.elapsed_time(b) for a, b in events]
    median = statistics.median(step_ms[1:])
    print(f"training [{TRAIN_ARCH}, fixed batch]: losses "
          f"{[round(x, 4) for x in losses]}; step ms (CUDA events) median "
          f"{median:.3f} of steps 2-{FIXED_STEPS}, first {step_ms[0]:.3f}, "
          f"range {min(step_ms[1:]):.3f}-{max(step_ms[1:]):.3f}; "
          f"{TRAIN_BATCH * TRAIN_SEQ / median * 1e3:,.0f} tokens/s at the "
          f"median; {smi}")
    if not losses[-1] < losses[0] or not all(math.isfinite(x)
                                             for x in losses):
        raise AssertionError(f"training: the fixed batch's loss did not "
                             f"fall: {losses}")
    del state, setup
    torch.cuda.empty_cache()
    return dict(step_ms=median, tok_s=tok_s, peak_gb=peak / 1e9)


def train_pods(smi):
    """Phase 22 (c): smollm-360m at full width on 2 pods, hierarchical,
    the int8 merge every ``POD_MERGE`` steps, ``POD_STEPS`` steps from the
    pipeline: the pods' divergence above 0 before each merge and 0 after
    it; each merge's device ms (CUDA events) and counted bytes."""
    import math

    import torch

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.optim import coord
    from repro_torch.txn import collectives

    cfg = registry.get_config(TRAIN_ARCH)
    setup = coord.build(cfg, coord.CoordConfig(mode="hierarchical",
                                               merge_every=POD_MERGE,
                                               compress="int8"),
                        _train_opt(total_steps=POD_STEPS),
                        registry.make_loss_fn, n_pods=2)
    pipe = Pipeline(DataConfig(cfg.vocab, TRAIN_SEQ, TRAIN_BATCH, SEED,
                               n_shards=2), cfg)
    state = setup.init_fn(SEED)
    merges = []
    for step in range(POD_STEPS):
        state = setup.step_fn(state, pipe.next_batch())
        if (step + 1) % POD_MERGE:
            continue
        before = _pod_divergence(state)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with collectives.counted() as stats:
            ev[0].record()
            state = setup.merge_fn(state)
            ev[1].record()
        torch.cuda.synchronize()
        after = _pod_divergence(state)
        merges.append(dict(step=step + 1, before=before, after=after,
                           ms=ev[0].elapsed_time(ev[1]),
                           bytes=dict(stats.bytes),
                           counts=dict(stats.counts)))
    m = setup.read_metrics(state)
    for row in merges:
        print(f"training [2 pods, hierarchical, int8 merge every "
              f"{POD_MERGE}]: merge after step {row['step']}: divergence "
              f"{row['before']:.4g} -> {row['after']}; {row['ms']:.3f} ms "
              f"(CUDA events); counted {row['counts']} {row['bytes']} bytes;"
              f" {smi}")
    print(f"training [2 pods]: step {m['step']}, loss_mean "
          f"{m['loss_mean']:.4f}, tokens {m['tokens']:.0f}; {smi}")
    if len(merges) != POD_STEPS // POD_MERGE or not all(
            r["before"] > 0 and math.isfinite(r["before"])
            and r["after"] == 0 for r in merges):
        raise AssertionError(f"training [2 pods]: the pods did not diverge "
                             f"between merges or a merge left them apart: "
                             f"{merges}")
    del state, setup
    torch.cuda.empty_cache()
    return merges


def train_restart(smi):
    """Phase 22 (d): under ``torch.use_deterministic_algorithms(True)``
    (the embedding's backward otherwise adds with atomics), a run of
    ``CKPT_AT`` steps that checkpoints (into a temporary directory under
    ``build/``) and a restart from it to ``TRAIN_STEPS`` end in the bits
    of an uninterrupted ``TRAIN_STEPS``-step run; the save's and the
    restore's host seconds."""
    import tempfile

    import torch

    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import registry
    from repro_torch.core import tree as T
    from repro_torch.runtime import train

    cfg = registry.get_config(TRAIN_ARCH)
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    seconds = {}

    def timed(fn, key):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            seconds[key] = time.perf_counter() - t0
            return out
        return call

    save, restore = ckpt.save, ckpt.restore
    ckpt.save, ckpt.restore = timed(save, "save"), timed(restore, "restore")
    try:
        with _deterministic(), tempfile.TemporaryDirectory(dir=build) as d:
            def tc(steps, ckpt_every):
                return train.TrainConfig(
                    steps=steps, log_every=steps, ckpt_every=ckpt_every,
                    ckpt_dir=d, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH,
                    seed=SEED, remat=True, opt=_train_opt())
            whole, m_whole = train.run(cfg, tc(TRAIN_STEPS, 0))
            train.run(cfg, tc(CKPT_AT, CKPT_AT))
            resumed, m_resumed = train.run(cfg, tc(TRAIN_STEPS, 0),
                                           restore_from=d)
            nbytes = sum(os.path.getsize(os.path.join(d, f))
                         for f in os.listdir(d))
    finally:
        ckpt.save, ckpt.restore = save, restore
    same = all(torch.equal(a, b) for a, b in zip(T.leaves(whole),
                                                 T.leaves(resumed)))
    print(f"training restart: checkpoint at step {CKPT_AT} "
          f"({nbytes / 1e9:.3f} GB on disk), save {seconds['save']:.3f} s, "
          f"restore {seconds['restore']:.3f} s; resumed to step "
          f"{m_resumed['step']} == the uninterrupted run bit for bit: "
          f"{same} (loss_mean {m_resumed['loss_mean']:.6f} / "
          f"{m_whole['loss_mean']:.6f}); {smi}")
    if not same or m_resumed["step"] != TRAIN_STEPS:
        raise AssertionError("training restart: the resumed run differs "
                             "from the uninterrupted one")
    del whole, resumed
    torch.cuda.empty_cache()
    return seconds


def train_pod_simulator(smi):
    """Phase 22 (e): ``PodSimulator`` on the card, 2 pods of reduced
    smollm-360m: 2 steps and a merge; pod 1 killed, a step of the
    survivor, pod 1 recovered from it, a step, a merge: every live pod's
    parameters finite, divergence 0 after each merge, and the fleet's
    G-counter counting each token once."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.optim import coord
    from repro_torch.runtime.failures import PodSimulator

    cfg = registry.get_config(TRAIN_ARCH).reduced()
    setup = coord.build(cfg, coord.CoordConfig(),
                        _train_opt(warmup_steps=1, total_steps=50),
                        registry.make_loss_fn)
    sim = PodSimulator(setup, 2)

    def batches(t):
        return [registry.make_train_batch(
            torch.Generator().manual_seed(100 * t + i), cfg, 2, 16)
            for i in range(2)]

    sim.step(batches(0))
    sim.step(batches(1))
    sim.merge()
    first = sim.divergence()
    sim.kill(1)
    sim.step(batches(2))
    valid_dead = sim.check_validity()
    sim.recover(1)
    sim.step(batches(3))
    apart = sim.divergence()
    sim.merge()
    fleet = sim.fleet_metrics()
    want = (4 + 3) * 2 * 16
    print(f"training PodSimulator [2 pods, reduced]: divergence after the "
          f"first merge {first}, before the last {apart:.4g}, after it "
          f"{sim.divergence()}; valid {valid_dead} / {sim.check_validity()};"
          f" fleet tokens {fleet['tokens']:.0f} (each counted once: "
          f"{want}); steps {[int(s.step) for s in sim.states]}; {smi}")
    if first != 0 or sim.divergence() != 0 or not apart > 0 or \
            not (valid_dead and sim.check_validity()) or \
            fleet["tokens"] != want:
        raise AssertionError("training PodSimulator: validity, divergence "
                             "or the fleet's token count is off")


def training(smi):
    """Phase 22: (a)-(e). Training launches none of the six kernels (B5
    and B6 have no backward, B1-B4 are TPC-C's)."""
    out = {}
    t0 = time.perf_counter()
    train_families_card_against_cpu(smi)
    out["card_vs_cpu_s"] = time.perf_counter() - t0
    out.update(train_full_width(smi))
    out["merges"] = train_pods(smi)
    out.update(train_restart(smi))
    train_pod_simulator(smi)
    return out


# phase 23: the dry run (repro_torch.launch.dryrun): each step traced on
# meta tensors (no memory, no launch), then, for (a) and (b), run on the
# card under the same counters, which must agree with the trace.
DRY_PEAK_TOL = 0.10       # (a): traced peak vs the step's own on the card
PREFILL_SHAPE = (8, 467)  # (b): phases 11-12's first prefill batch (B, S)
DRY_SHARDS = 4            # (c): phase 16's deployment
# (d): the full sweep traces about 1.6 M ops (the rwkv6 and hymba chunk
# loops at 4k and 32k tokens), several minutes of host time at some 200 us
# an op, so the card runs every shape of smollm-360m and one cell of each
# other family, on 1 and 2 pods
DRY_CELLS = [("smollm-360m", s) for s in
             ("train_4k", "prefill_32k", "decode_32k", "long_500k")] + [
    ("olmoe-1b-7b", "decode_32k"), ("rwkv6-3b", "prefill_32k"),
    ("hymba-1.5b", "long_500k"), ("llama-3.2-vision-11b", "decode_32k"),
    ("whisper-tiny", "train_4k")]


def _dry_line(tag, rec, smi):
    m = rec["memory"]
    print(f"dry run [{tag}]: peak {m['peak_bytes'] / 1e9:.3f} GB (arguments "
          f"{m['argument_bytes'] / 1e9:.3f} GB), "
          f"{rec['cost']['flops'] / 1e12:.4f} TFLOP, {rec['ops']['total']} "
          f"ops, collectives {rec['collectives']['describe']}; traced in "
          f"{rec['trace_seconds']:.3f} s; {smi}")


def _dry_held(tag, traced, ran, kernel=None):
    """(a), (b): the card's FLOPs, ops (kind by kind) and, for a kernel,
    its counted operations equal the trace's."""
    bad = []
    if traced["cost"] != ran["cost"]:
        bad.append("FLOPs")
    if traced["ops"]["kinds"] != ran["ops"]["kinds"]:
        bad.append("ops")
    if kernel is not None and not traced["cost"]["by_op"].get(kernel):
        bad.append(f"no {kernel} operations")
    if bad:
        raise AssertionError(f"dry run [{tag}]: the card disagrees with "
                             f"the trace on {bad}: traced {traced['cost']}"
                             f", card {ran['cost']}; ops the trace has "
                             f"over the card "
                             f"{_counter(traced) - _counter(ran)}, the card "
                             f"over the trace "
                             f"{_counter(ran) - _counter(traced)}")


def _counter(rec):
    from collections import Counter
    return Counter(rec["ops"]["kinds"])


def _card_run(fn, args, traced):
    """``fn(*args)`` on the card under the dry run's counters, after one
    warm-up call, from a reset peak: (record, ``max_memory_allocated``,
    the part of it earlier phases still hold, the step's own peak). The
    step's own peak is ``max_memory_allocated`` less what was allocated
    before the call and is not among its arguments (whose bytes are the
    trace's ``peak_bytes - temp_bytes``): what the trace predicts."""
    import gc

    import torch

    from repro_torch.launch import dryrun

    fn(*args)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    rec, out = dryrun.trace(fn, args)
    torch.cuda.synchronize()
    del out
    peak = torch.cuda.max_memory_allocated()
    other = before - (traced["memory"]["peak_bytes"]
                      - traced["memory"]["temp_bytes"])
    return rec, peak, other, peak - other


def dry_train_step(smi):
    """Phase 23 (a): phase 22's step (smollm-360m, sync, 8 x 512, remat,
    bf16 on float32 masters, escrow clip) traced, then run on the card:
    FLOPs and ops equal, the traced peak within ``DRY_PEAK_TOL`` of the
    step's own peak on the card (``max_memory_allocated`` less what
    earlier phases still hold, :func:`_card_run`)."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig

    cfg = registry.get_config(TRAIN_ARCH)
    shape = ShapeConfig("phase 22", TRAIN_SEQ, TRAIN_BATCH, "train")
    traced = dryrun.trace_train(cfg, shape, 1)
    _dry_line(f"{TRAIN_ARCH}, train {TRAIN_BATCH} x {TRAIN_SEQ}", traced,
              smi)
    setup = dryrun.train_setup(cfg, device="cuda")
    state = setup.init_fn(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = registry.make_train_batch(gen, cfg, TRAIN_BATCH, TRAIN_SEQ)
    ran, peak, other, own = _card_run(setup.step_fn, (state, batch),
                                      traced)
    _dry_held("train step", traced, ran)
    want = traced["memory"]["peak_bytes"]
    gap = (want - own) / own
    print(f"dry run [{TRAIN_ARCH}, train step on the card]: "
          f"{ran['cost']['flops'] / 1e12:.4f} TFLOP and {ran['ops']['total']}"
          f" ops, equal to the trace; max_memory_allocated {peak:,} B, "
          f"{other:,} B of it held by earlier phases, so the step's own "
          f"peak {own:,} B against the traced {want:,} B ({gap:+.2%}); "
          f"{smi}")
    if abs(gap) > DRY_PEAK_TOL:
        raise AssertionError(f"dry run: the traced peak is {gap:+.2%} off "
                             f"the card's")
    del state, batch, setup
    torch.cuda.empty_cache()
    return dict(flops=traced["cost"]["flops"], ops=traced["ops"]["total"],
                peak=want, max_memory_allocated=peak, gap=gap)


def dry_prefill(arch, kernel, smi):
    """Phase 23 (b): a prefill batch of ``PREFILL_SHAPE`` through B5 or B6,
    traced (the shape-only route) and run on the card (the kernel): FLOPs,
    ops and the kernel's counted operations equal. Returns the card's
    launches."""
    import torch

    from repro_torch.configs import registry
    from repro_torch.core import tree as T
    from repro_torch.launch import dryrun
    from repro_torch.models import layers as L

    cfg = registry.get_config(arch)
    B, S = PREFILL_SHAPE
    step = dryrun.prefill_step(cfg)
    tokens = torch.empty((B, S), dtype=torch.int32, device="meta")
    traced, _ = dryrun.trace(step, (dryrun.serving_params_abs(cfg),
                                    {"tokens": tokens}))
    _dry_line(f"{arch}, prefill {B} x {S}", traced, smi)
    dt = L.dtype_of(cfg)
    params = T.map(lambda x: x.to(dt) if x.is_floating_point() else x,
                   L.stacked(registry.init_params(cfg, SEED, "cuda")))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    batch = {"tokens": torch.randint(0, cfg.vocab, (B, S), generator=gen,
                                     device="cuda", dtype=torch.int32)}
    launches = kernel.launches
    ran, peak, other, own = _card_run(step, (params, batch), traced)
    name = f"repro_torch.{kernel.__name__[:-5]}"
    _dry_held(f"{arch} prefill", traced, ran, name)
    n = kernel.launches - launches
    print(f"dry run [{arch}, prefill on the card]: {n} {kernel.__name__} "
          f"launches (one a layer a call, warm-up included), "
          f"{ran['cost']['by_op'][name]:,} kernel operations a call equal "
          f"to the shape-only route's, {ran['ops']['total']} ops; traced "
          f"peak {traced['memory']['peak_bytes']:,} B, the step's own on "
          f"the card {own:,} B (max_memory_allocated {peak:,} B, {other:,}"
          f" B of it held by earlier phases); {smi}")
    if n != 2 * cfg.n_layers:
        raise AssertionError(f"dry run: {n} launches of {kernel.__name__}")
    del params
    torch.cuda.empty_cache()
    return n


def dry_server_decode(smi):
    """Phase 23 (b): the ops of one decode step of the ``Server``'s own
    model (float32 masters cast at each use) at phases 11-12's batch and
    capacity, traced: the count a captured decode step (ROADMAP item 13)
    would replay."""
    from repro_torch.configs import registry
    from repro_torch.launch import dryrun
    from repro_torch.models.config import ShapeConfig

    for arch in ("smollm-360m", "rwkv6-3b"):
        cfg = registry.get_config(arch)
        cache, token = registry.decode_input_specs(
            cfg, ShapeConfig("serve", 2048, SERVE_BATCH, "decode"))
        rec, _ = dryrun.trace(registry.make_decode_fn(cfg), (
            registry.init_params(cfg, SEED, "meta"), cache, token))
        print(f"dry run [{arch}, the Server's decode step, batch "
              f"{SERVE_BATCH}, capacity 2048]: {rec['ops']['total']} ops "
              f"({rec['ops']['top']}), {rec['cost']['flops'] / 1e12:.4f} "
              f"TFLOP; {smi}")


def dry_sweep(smi):
    """Phase 23 (d)-(e): ``DRY_CELLS`` traced at full width on 1 and 2
    pods, the wall time, and a line a cell."""
    import torch

    from repro_torch.launch import dryrun

    hbm = dryrun.hbm_bytes(torch.device("cuda"), None)
    t0 = time.perf_counter()
    cells = [dryrun.run_cell(arch, shape, pods, hbm)
             for pods in (1, 2) for arch, shape in DRY_CELLS]
    wall = time.perf_counter() - t0
    for c in cells:
        tag = f"{c['arch']} {c['shape']} pods={c['pods']}"
        if not c["ok"]:
            raise AssertionError(f"dry run [{tag}]: {c['error']}")
        if c.get("skipped"):
            print(f"dry run cell [{tag}]: skipped, {c['reason']}")
            continue
        print(f"dry run cell [{tag}]: fits={c['fits']} "
              f"{c['memory']['peak_bytes'] / 1e9:.3f} GB a card, "
              f"{c['cost']['flops'] / 1e12:.4f} TFLOP a step, "
              f"{c['ops']['total']} ops a step, collectives "
              f"{c['collectives']['describe']}")
    print(f"dry run sweep: {len(cells)} cells in {wall:.1f} s (host), "
          f"against {hbm / 2 ** 30:.2f} GiB; {smi}")
    return wall


def dry_run(smi):
    """Phase 23: (a) the training step, (b) the B5 and B6 prefills and
    the Server's decode step, (c)
    ``--arch tpcc`` on ``DRY_SHARDS`` shards, (d)-(e) the sweep. Returns
    the launches of the card runs, by kernel."""
    from repro_torch.kernels.escrow_admit import escrow_admit_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ramp_read import ramp_read_cuda
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    from repro_torch.kernels.txn_megastep import txn_megastep_cuda
    from repro_torch.launch import dryrun

    wrappers = dict(escrow_admit=escrow_admit_cuda,
                    txn_megastep=txn_megastep_cuda, ramp_read=ramp_read_cuda,
                    flash_attention=flash_attention_cuda,
                    rwkv6_scan=rwkv6_scan_cuda)
    for w in wrappers.values():
        w.launches = 0
    dry_train_step(smi)
    dry_prefill("smollm-360m", flash_attention_cuda, smi)
    dry_prefill("rwkv6-3b", rwkv6_scan_cuda, smi)
    dry_server_decode(smi)
    t0 = time.perf_counter()
    cell = dryrun.tpcc_cell(DRY_SHARDS, "cuda")
    if not cell["ok"]:
        raise AssertionError(f"dry run [tpcc]: {cell['error']}")
    paths = [k for k, v in cell.items() if isinstance(v, dict) and "run" in v]
    print(f"dry run [tpcc, {cell['warehouses']} spec-scale warehouses, "
          f"{DRY_SHARDS} shards]: {len(paths)} paths traced, none but the "
          f"refresh calls a collective (refresh "
          f"{cell['escrow_refresh']['collectives']['describe']}); peak "
          f"{cell['peak_bytes'] / 1e9:.3f} GB; sparse escrow "
          f"{cell['escrow_layout']['reduction_vs_dense']:.1f}x under dense; "
          f"walk {cell['walk']}; ledger hot collectives "
          f"{cell['obs_ledger']['hot_collectives']}; audit "
          f"{cell['escrow_audit']} in {time.perf_counter() - t0:.1f} s; "
          f"{smi}")
    dry_sweep(smi)
    return {k: w.launches for k, w in wrappers.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.stdout.reconfigure(line_buffering=True)

    from repro_torch.kernels import build
    from repro_torch.kernels.escrow_admit import escrow_admit_cuda
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.lattice_merge import lattice_merge_cuda
    from repro_torch.kernels.ramp_read import ramp_read_cuda
    from repro_torch.kernels.rwkv6_scan import rwkv6_scan_cuda
    from repro_torch.kernels.txn_megastep import txn_megastep_cuda
    from repro_torch.txn import (TPCCScale, assert_audit, init_state,
                                 run_loop)
    from repro_torch.txn.engine import single_host_engine

    # -- phase 1: the card and the build -------------------------------------
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {name} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})")
    print(f"nvidia-smi: {smi}")
    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(build.KERNELS)})")
    for k in ("escrow_admit", "txn_megastep"):   # ptxas -v: registers, spills
        print(f"ptxas [{k}]: " + " | ".join(
            line.split(":", 1)[-1].strip() for line in logs[k].splitlines()
            if "Used" in line or "spill" in line))

    scale = TPCCScale.spec_scale(WAREHOUSES)
    tables = init_state(scale, seed=SEED)
    print(f"deployment: {WAREHOUSES} spec-scale warehouses, "
          f"{sum(x.numel() * x.element_size() for x in tables) / 1e9:.2f} GB "
          f"of tables on the card")

    # -- phase 2: kernel parity at the main path's shapes --------------------
    eng = single_host_engine(scale, stock_invariant="strict",
                             admission="kernel", effects="fused")
    tables.s_quantity.mul_(STOCK_MULTIPLIER)
    first, hard = kernel_parity(eng, tables, eng.init_escrow(tables))
    parity_err = {k: max(first[k]["max_abs_err"], hard[k]["max_abs_err"])
                  for k in first}
    del tables

    # -- phases 3-4: the New-Order main path, launch counts from 0 ----------
    escrow_admit_cuda.launches = 0
    txn_megastep_cuda.launches = 0
    ramp_read_cuda.launches = 0

    merge = single_host_engine(scale)
    state = init_state(scale, seed=SEED)
    state, _, st = run_loop(merge, state, batch_per_shard=BATCH,
                            n_batches=N_BATCHES, remote_frac=REMOTE_FRAC,
                            merge_every=MERGE_EVERY, seed=SEED, fused=False)
    t0 = time.perf_counter()
    rep = assert_audit(state).describe()
    print(f"merge: {st.neworders} New-Orders committed, "
          f"{st.throughput:,.0f} txn/s, {st.anti_entropy_rounds} "
          f"anti-entropy rounds; {rep} in {time.perf_counter() - t0:.1f} s")
    s_merge = state    # phase 15's non-strict 2PC must end here

    s_fused, e_fused, m_fused, rep = escrow_run(scale, "kernel", "fused")
    mega_launches = txn_megastep_cuda.launches
    print(f"escrow (megastep kernel): {m_fused.neworders} committed, "
          f"{m_fused.aborts} aborts, {m_fused.cold_rejects} cold rejects, "
          f"{m_fused.refreshes} refreshes, {m_fused.throughput:,.0f} txn/s;"
          f" txn_megastep launches={mega_launches}; {rep}")
    # an abort comes only from a residual transaction the walk refused
    if mega_launches < N_BATCHES or m_fused.aborts <= 0:
        raise AssertionError("the escrow loop did not run the megastep "
                             "kernel on every batch, or its walk never "
                             "had residual work")

    s_adm, e_adm, m_adm, rep = escrow_run(scale, "kernel", "scan",
                                          audit=False)
    launches = {"escrow_admit": escrow_admit_cuda.launches,
                "txn_megastep": txn_megastep_cuda.launches}
    print(f"escrow (escrow_admit kernel): {m_adm.neworders} committed, "
          f"{m_adm.aborts} aborts, {m_adm.throughput:,.0f} txn/s; "
          f"escrow_admit launches={launches['escrow_admit']}")
    print(f"main-path launches: {json.dumps(launches)}")
    for k, n in launches.items():
        if n == 0:
            raise AssertionError(f"{k} was not launched on the main path")
    if ramp_read_cuda.launches:
        raise AssertionError("New-Order alone launched ramp_read")
    bad = _same(s_fused, s_adm) + _same(e_fused, e_adm)
    if bad:
        raise AssertionError(f"megastep path != escrow_admit path: {bad}")

    # the kernels on the problem the main path's next batch meets at the
    # end of the run (stock run down, so the walk has residual work): the
    # times and bounds of the kernels' record
    timing = check_and_time("main path after the run", *admission_problem(
        eng, s_fused, e_fused, main_path_batch(eng, N_BATCHES)))
    if timing["txn_megastep"]["n_res"] <= 0:
        raise AssertionError("the timed problem has no residual work")
    walk_costs(timing, first, hard)

    # -- phase 5: the same escrow run through the plain path on the card -----
    s_plain, e_plain, m_plain, _ = escrow_run(scale, "scan", "scan",
                                              audit=False)
    counts = lambda m: (m.neworders, m.aborts, m.cold_rejects, m.refreshes,
                        m.anti_entropy_rounds)
    bad = _same(s_fused, s_plain) + _same(e_fused, e_plain)
    if bad or len({counts(m) for m in (m_fused, m_adm, m_plain)}) != 1:
        raise AssertionError(f"kernel path != plain path: {bad} "
                             f"{counts(m_fused)} {counts(m_plain)}")
    print(f"plain path on the card: bit-equal state and escrow, counts "
          f"{counts(m_plain)}, {m_plain.throughput:,.0f} txn/s")
    del s_fused, s_adm, s_plain

    # -- phase 6: small input, kernels on the card vs plain on the CPU -------
    small = TPCCScale(n_warehouses=2, districts=2, customers=8, n_items=400,
                      order_capacity=64)
    cpu = lambda t: type(t)(*(x.cpu() for x in t))
    mix_counts = lambda m: counts(m) + (
        m.payments, m.order_statuses, m.stock_levels, m.deliveries,
        m.reads_found, m.fractures_observed, m.lines_repaired)
    for tag, mix in (("New-Order", None), ("five-transaction mix", MIX)):
        sk, ek, mk, _ = escrow_run(small, "kernel", "fused", device="cuda",
                                   batch=16, n_batches=6, mix=mix)
        sc, ec, mc, _ = escrow_run(small, "scan", "scan", device="cpu",
                                   batch=16, n_batches=6, audit=False,
                                   mix=mix)
        bad = _same(cpu(sk), sc) + _same(cpu(ek), ec)
        if bad or mix_counts(mk) != mix_counts(mc):
            raise AssertionError(f"small run ({tag}): card != CPU plain "
                                 f"path: {bad} {mix_counts(mk)} "
                                 f"{mix_counts(mc)}")
        print(f"small run ({tag}): card kernels == CPU plain path, counts "
              f"{mix_counts(mk)}")
    small_dense_and_2pc(small)

    # -- phase 7: the mix in the merge regime, launch counts from 0 ----------
    ramp_read_cuda.launches = 0
    state = init_state(scale, seed=SEED)
    state, _, mm = run_loop(merge, state, batch_per_shard=BATCH,
                            n_batches=N_BATCHES, remote_frac=REMOTE_FRAC,
                            merge_every=MERGE_EVERY, seed=SEED, fused=False,
                            **MIX)
    launches["ramp_read"] = ramp_read_cuda.launches
    t0 = time.perf_counter()
    rep = assert_audit(state).describe()
    print(f"mix, merge: {mm.neworders} New-Order, {mm.payments} Payment, "
          f"{mm.order_statuses} Order-Status ({mm.reads_found} found), "
          f"{mm.stock_levels} Stock-Level, {mm.deliveries} Delivery; "
          f"{mm.throughput:,.0f} txn/s; fractures_observed="
          f"{mm.fractures_observed} lines_repaired={mm.lines_repaired}; "
          f"ramp_read launches={launches['ramp_read']}; {rep} in "
          f"{time.perf_counter() - t0:.1f} s")
    if mm.fractures_observed or launches["ramp_read"] < N_BATCHES:
        raise AssertionError("the merge mix observed a fracture or did not "
                             "read through the ramp_read kernel")

    # -- phase 8: the mix in the escrow regime, launch counts from 0 ---------
    ramp_read_cuda.launches = 0
    txn_megastep_cuda.launches = 0
    _, _, me, rep = escrow_run(scale, "kernel", "fused", mix=MIX)
    print(f"mix, escrow (megastep kernel): {me.neworders} New-Order "
          f"committed, {me.aborts} aborts, {me.payments} Payment, "
          f"{me.order_statuses} Order-Status, {me.stock_levels} "
          f"Stock-Level, {me.deliveries} Delivery; {me.throughput:,.0f} "
          f"txn/s; fractures_observed={me.fractures_observed}; launches "
          f"txn_megastep={txn_megastep_cuda.launches} ramp_read="
          f"{ramp_read_cuda.launches}; {rep}")
    if me.fractures_observed or min(txn_megastep_cuda.launches,
                                    ramp_read_cuda.launches) < N_BATCHES:
        raise AssertionError("the escrow mix observed a fracture or missed "
                             "a kernel")
    launches["txn_megastep"] += txn_megastep_cuda.launches
    launches["ramp_read"] += ramp_read_cuda.launches

    # -- phase 9: the ramp_read kernel on problems (a) and (b) ---------------
    read_a, read_a_hidden, read_b = ramp_read_problems(merge, state)
    timing["ramp_read"] = dict(read_a, max_abs_err=max(
        r["max_abs_err"] for r in (read_a, read_a_hidden, read_b)))

    # -- phase 10: replica anti-entropy, launch counts from 0 ----------------
    timing["lattice_merge"] = anti_entropy(state)
    launches["lattice_merge"] = timing["lattice_merge"]["launches"]
    s_mix = state      # phase 15's 2PC read_step reads it
    torch.cuda.empty_cache()

    # -- phase 11: dense serving, launch counts from 0 -----------------------
    out, launches["flash_attention"] = serve_main_path("smollm-360m",
                                                       flash_attention_cuda)
    if flash_attention_cuda.route_launches["tensor_core"] != \
            launches["flash_attention"]:
        raise AssertionError(f"flash_attention: not every main-path launch "
                             f"took the tensor-core route: "
                             f"{flash_attention_cuda.route_launches}")
    timing["flash_attention"] = flash_check_and_time(out)
    del out
    torch.cuda.empty_cache()

    # -- phase 12: RWKV serving, launch counts from 0 ------------------------
    out, launches["rwkv6_scan"] = serve_main_path("rwkv6-3b", rwkv6_scan_cuda)
    timing["rwkv6_scan"] = scan_check_and_time(out)
    del out
    torch.cuda.empty_cache()

    # -- phase 13: small serving runs, card kernels vs CPU plain path --------
    card_against_cpu()
    families_card_against_cpu()

    # -- phase 14: dense escrow on phase 4's stream, launch counts from 0 ----
    s_dense, m_dense, dense_launches, _ = dense_escrow(scale, eng,
                                                       (m_fused, m_adm))
    for k, n in dense_launches.items():
        launches[k] += n

    # -- phase 15: the coordinated baseline, launch counts from 0 ------------
    best = max(m.throughput for m in (m_fused, m_adm, m_dense))
    for k, n in coordinated_baseline(scale, merge, s_merge, s_mix, s_dense,
                                     m_dense, best).items():
        launches[k] += n
    del s_merge, s_mix, s_dense
    torch.cuda.empty_cache()

    # -- phase 16: replicas on one card, launch counts from 0 ----------------
    t0 = time.perf_counter()
    for k, n in replicas_on_one_card(scale).items():
        launches[k] += n
    print(f"replicas: phase 16 in {time.perf_counter() - t0:.1f} s")

    # -- phase 17: the cold-retry ring on replicas, launch counts from 0 -----
    t0 = time.perf_counter()
    ring_launches, resume_end = cold_retry_ring(scale)
    for k, n in ring_launches.items():
        launches[k] += n
    print(f"ring: phase 17 in {time.perf_counter() - t0:.1f} s")

    # -- phase 18: recovery and liveness, launch counts from 0 ---------------
    t0 = time.perf_counter()
    for k, n in disk_resume(scale, resume_end).items():
        launches[k] += n
    del resume_end
    launches["txn_megastep"] += liveness_runs(scale)
    launches["txn_megastep"] += sim_rows()
    print(f"recovery: phase 18 in {time.perf_counter() - t0:.1f} s")

    # -- phase 19: the fused executor, launch counts from 0 -----------------
    t0 = time.perf_counter()
    for k, n in fused_executor(scale, smi).items():
        launches[k] += n
    print(f"fused: phase 19 in {time.perf_counter() - t0:.1f} s")

    # -- phase 20: the observability plane, launch counts from 0 ------------
    t0 = time.perf_counter()
    for k, n in observability(scale, smi).items():
        launches[k] += n
    print(f"obs: phase 20 in {time.perf_counter() - t0:.1f} s")

    # -- phase 21: the moe, hybrid, vlm and audio families, counts from 0 ---
    t0 = time.perf_counter()
    n, rows = serve_families(logs)
    launches["flash_attention"] += n
    timing["flash_attention"]["problems"] = rows
    timing["flash_attention"]["max_abs_err"] = max(
        [timing["flash_attention"]["max_abs_err"]]
        + [r["max_abs_err"] for r in rows])
    print(f"families: phase 21 in {time.perf_counter() - t0:.1f} s")

    # -- phase 22: training, no kernel launched ------------------------------
    t0 = time.perf_counter()
    wrappers = (escrow_admit_cuda, txn_megastep_cuda, ramp_read_cuda,
                flash_attention_cuda, rwkv6_scan_cuda,
                lattice_merge_cuda)
    before = [w.launches for w in wrappers]
    training(smi)
    if [w.launches for w in wrappers] != before:
        raise AssertionError("training launched a kernel")
    print(f"training: phase 22 in {time.perf_counter() - t0:.1f} s, no "
          f"kernel launched")

    print(f"launches, phases 1-22: {json.dumps(launches)}")

    # -- phase 23: the dry run, launch counts from 0 -------------------------
    t0 = time.perf_counter()
    for k, n in dry_run(smi).items():
        launches[k] += n
    print(f"dry run: phase 23 in {time.perf_counter() - t0:.1f} s")
    print(f"launches, every main path: {json.dumps(launches)}")

    for k in ("ramp_read", "lattice_merge", "flash_attention", "rwkv6_scan"):
        parity_err[k] = 0.0
    replaces = {"escrow_admit": "src/repro/kernels/escrow_admit.py:184",
                "txn_megastep": "src/repro/kernels/txn_megastep.py:255",
                "ramp_read": "src/repro/kernels/ramp_read.py:73",
                "lattice_merge": "src/repro/kernels/lattice_merge.py:64",
                "flash_attention": "src/repro/kernels/flash_attention.py:95",
                "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:93"}
    record = {"kernels": [
        {"name": k, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{k}.cu",
         "replaces": replaces[k], "launches": launches[k],
         "max_abs_err": max(parity_err[k], timing[k]["max_abs_err"]),
         "ms": timing[k]["ms"],
         "plain_ms": timing[k]["plain_ms"], "bound_ms": timing[k]["bound_ms"],
         "bound_by": timing[k].get("bound_by", "bytes"),
         "library_ms": timing[k].get("library_ms"),
         **{f: timing[k][f] for f in ("ms_n_res_0", "us_per_residual",
                                      "problems") if f in timing[k]}}
        for k in build.KERNELS]}
    print(f"nvidia-smi: {smi}")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
