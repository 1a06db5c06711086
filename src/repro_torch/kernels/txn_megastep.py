"""The transaction megastep — phases 2-4 of strict-stock New-Order —
as a hand-written CUDA kernel (``csrc/txn_megastep.cu``) beside its plain
torch version.

Phase 1 (the contention gate) runs outside as torch ops; the kernel runs
the residual FCFS walk, settles the fast path into ``avail``, takes each
transaction's committed per-district rank and the district counts,
accumulates the three stock slabs, and stamps ``ol_ts`` / ``amount``. It
returns effect PRODUCTS that the caller (txn/tpcc.py
``_neworder_fused_effects``) lands with dense adds and row scatters.

The walk is escrow_admit's (``csrc/residual_walk.cuh``): tiles of the
residual window staged in shared memory and walked there by one warp
(:func:`~repro_torch.kernels.escrow_admit.walk_shape`). The rank then
reads the batch's keys and verdicts from shared memory, a chunk of the
block's threads at a time, each chunk starting from the counts of the
chunks before it.

Bit-exactness holds phase by phase: rank and d_count are integer counts in
batch order; the slabs are integer sums, exact in any order (``s_ytd`` is
float32 but its addends are integers far below 2**24, where float32 sums
are exact in any association); the stamps are the same elementwise
formulas.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .escrow_admit import residual_fcfs, settle_fast, walk_shape


class MegastepOut(NamedTuple):
    """The megastep's effect products (kernel, plain version and oracle
    alike)."""

    committed: torch.Tensor   # [B] bool — FCFS admission verdicts
    avail: torch.Tensor       # [A] int32 — fully settled availability
    rank: torch.Tensor        # [B] int32 — committed rank within the key
    d_count: torch.Tensor     # [n_keys] int32 — committed txns per key
    stock_dec: torch.Tensor   # [n_cells] int32 — admitted decrement
    stock_cnt: torch.Tensor   # [n_cells] int32 — admitted order lines
    stock_rcnt: torch.Tensor  # [n_cells] int32 — admitted remote lines
    ol_ts: torch.Tensor       # [B, L] int32 — RAMP write-set stamp
    amount: torch.Tensor      # [B, L] float32 — price x qty


def megastep_effect_products(committed, qty, line_valid, key_local,
                             cell_local, local_line, remote_line, ramp_ts,
                             price_row, *, n_keys: int, n_cells: int
                             ) -> tuple[torch.Tensor, ...]:
    """The plain version of phases 3-4 (admission happens upstream):
    a sort-based committed rank, one segment sum for ``d_count``, one
    stacked ``[N, 3]`` segment sum for the three slabs, and the stamps.

    Returns (rank, d_count, stock_dec, stock_cnt, stock_rcnt, ol_ts,
    amount) — the MegastepOut tail.
    """
    B = qty.shape[0]
    dev = qty.device
    c32 = committed.to(torch.int32)

    # within a key group (contiguous after a stable sort) the rank is the
    # group-local exclusive cumsum of the commit mask
    order = torch.argsort(key_local, stable=True)
    ks = key_local[order]
    cs = c32[order]
    excl = torch.cumsum(cs, 0).to(torch.int32) - cs
    start = torch.cat([torch.ones((1,), dtype=torch.bool, device=dev),
                       ks[1:] != ks[:-1]])
    last_start = torch.cummax(
        torch.where(start, torch.arange(B, device=dev), 0), 0).values
    rank = torch.zeros((B,), dtype=torch.int32, device=dev)
    rank[order] = excl - excl[last_start]

    d_count = torch.zeros((n_keys,), dtype=torch.int32, device=dev)
    d_count.index_add_(0, key_local.long(), c32)

    m = committed[:, None] & local_line
    ids = torch.where(m, cell_local, 0).reshape(-1).long()
    vals = torch.stack([torch.where(m, qty, 0).reshape(-1),
                        m.reshape(-1).to(torch.int32),
                        (m & remote_line).reshape(-1).to(torch.int32)],
                       1).to(torch.int32)
    slabs = torch.zeros((n_cells, 3), dtype=torch.int32, device=dev)
    slabs.index_add_(0, ids, vals)

    ol_ts = torch.where(line_valid, ramp_ts[:, None], -1).to(torch.int32)
    amount = torch.where(line_valid, price_row * qty.to(price_row.dtype),
                         0.0)
    return (rank, d_count, slabs[:, 0], slabs[:, 1], slabs[:, 2], ol_ts,
            amount)


def txn_megastep_plain(avail0, slot, qty, line_valid, fast, res_idx, n_res,
                       key_local, cell_local, local_line, remote_line,
                       ramp_ts, price_row, *, n_keys: int, n_cells: int
                       ) -> MegastepOut:
    """The plain version of the kernel, with its signature: the residual
    walk (:func:`residual_fcfs`), the fast path's settle scatter, and
    :func:`megastep_effect_products`. ``avail0`` is left as it was."""
    committed, avail = residual_fcfs(avail0, slot, qty, line_valid, fast,
                                     res_idx, n_res)
    settle_fast(avail, slot, qty, line_valid, fast)
    return MegastepOut(committed, avail, *megastep_effect_products(
        committed, qty, line_valid, key_local, cell_local, local_line,
        remote_line, ramp_ts, price_row, n_keys=n_keys, n_cells=n_cells))


def txn_megastep_cuda(avail0, slot, qty, line_valid, fast, res_idx, n_res,
                      key_local, cell_local, local_line, remote_line,
                      ramp_ts, price_row, *, n_keys: int, n_cells: int
                      ) -> MegastepOut:
    """Phases 2-4 on the card, one launch of ``csrc/txn_megastep.cu``.
    ``fast``/``res_idx``/``n_res`` come from the gate and
    ``residual_order``. Returns :class:`MegastepOut` with ``avail`` fully
    settled: the kernel updates ``avail0`` in place and returns it, so pass
    a vector the caller no longer needs (the engine builds a fresh one every
    batch). Any ``B``; ``d_count`` and the dense slabs are zeroed here, in
    one fill at the HBM rate, and are views into it. Launches on the
    current stream without synchronising; ``txn_megastep_cuda.launches``
    counts the launches."""
    B, L = slot.shape
    A = avail0.shape[0]
    if L > 32:
        raise ValueError(f"txn_megastep kernel holds one line per lane: "
                         f"L={L} > 32")
    for x, name, dtype, shape in (
            (avail0, "avail0", torch.int32, (A,)),
            (slot, "slot", torch.int32, (B, L)),
            (qty, "qty", torch.int32, (B, L)),
            (line_valid, "line_valid", torch.bool, (B, L)),
            (fast, "fast", torch.bool, (B,)),
            (res_idx, "res_idx", torch.int32, (B,)),
            (n_res, "n_res", torch.int32, (1,)),
            (key_local, "key_local", torch.int32, (B,)),
            (cell_local, "cell_local", torch.int32, (B, L)),
            (local_line, "local_line", torch.bool, (B, L)),
            (remote_line, "remote_line", torch.bool, (B, L)),
            (ramp_ts, "ramp_ts", torch.int32, (B,)),
            (price_row, "price_row", torch.float32, (B, L))):
        build.check_tensor(x, name, dtype, shape)
    dev = avail0.device
    i32 = dict(dtype=torch.int32, device=dev)
    counts = torch.zeros((n_keys + 3 * n_cells,), **i32)
    slabs = counts[n_keys:].view(3, n_cells)
    out = MegastepOut(
        committed=torch.empty_like(fast), avail=avail0,   # committed: in kernel
        rank=torch.empty((B,), **i32), d_count=counts[:n_keys],
        stock_dec=slabs[0], stock_cnt=slabs[1], stock_rcnt=slabs[2],
        ol_ts=torch.empty((B, L), **i32),
        amount=torch.empty((B, L), dtype=torch.float32, device=dev))
    fn = build.load("txn_megastep", [ctypes.c_void_p] * 21
                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    ins = (n_res, res_idx, slot, qty, line_valid, fast, key_local,
           cell_local, local_line, remote_line, ramp_ts, price_row)
    err = fn(*(x.data_ptr() for x in ins), *(x.data_ptr() for x in out),
             B, L, *walk_shape(B, L),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check("txn_megastep", err)
    txn_megastep_cuda.launches += 1
    return out


txn_megastep_cuda.launches = 0
