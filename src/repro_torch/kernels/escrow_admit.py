"""Two-level FCFS escrow admission: the contention gate (Level 1, torch ops)
and the residual FCFS walk (Level 2) as a hand-written CUDA kernel
(``csrc/escrow_admit.cu``) beside its plain torch version.

Level 1 classifies transactions by per-cell TOTAL batch demand against
headroom: where demand fits, admission is monotone and any order commits
every transaction (the proof is in the reference's ``contention_gate``
docstring), so only the *residual* transactions — those with a line on an
oversubscribed cell — replay FCFS, in batch order, against the original
``avail0``. Level 2 returns ``avail`` carrying the residual reservations
only; the fast path settles with one scatter outside (:func:`settle_fast`).

On the card Level 2 is one block (``csrc/residual_walk.cuh``): it walks the
residual window in tiles of at most T transactions (:func:`walk_shape`),
staging each tile's lines and the avail cells they name in shared memory,
so the serial walk over the tile touches no global memory; each tile's
cells are written back before the next is gathered, so the tiles equal
one walk. T comes from the shared memory a block may use: the main path's
B = 256, L = 15 is one tile.

On a tensor without data the wrapper takes its shape-only route
(``build.shape_only``). The walk is integer work: it counts no operation
to ``FlopCounterMode``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build


# threads of the walk's block (kThreads in csrc/escrow_admit.cu and
# csrc/txn_megastep.cu) and the dynamic shared memory a walk tile may take,
# of the 227 KB a block of the H100 may opt into (the megastep adds 5 KB of
# its own)
WALK_THREADS = 1024
WALK_SMEM_BUDGET = 200 * 1024

_mark = build.launch_marker("escrow_admit", lambda B, L: 0)


def walk_table_size(lines: int) -> int:
    """Entries of the walk's hash table for a tile of ``lines`` lines: a
    power of two of at least twice the lines, at least 32 (``table_size``
    in ``csrc/residual_walk.cuh``)."""
    h = 32
    while h < 2 * lines:
        h *= 2
    return h


def walk_hash(slot, H: int):
    """The first entry the walk's table probes for ``slot`` (an int or an
    int64 array) in a table of ``H`` entries: Fibonacci hashing, the top
    log2(H) bits of the low 32 of slot x 0x9E3779B9 (``hash`` in
    ``csrc/residual_walk.cuh``)."""
    return ((slot * 0x9E3779B9) & 0xFFFFFFFF) >> (32 - H.bit_length() + 1)


def walk_smem_bytes(T: int, L: int) -> int:
    """Dynamic shared memory of a walk tile of ``T`` transactions of ``L``
    lines: four int32 arrays of its lines, the table's int32 keys and
    values, a verdict byte a transaction; rounded up to 16 bytes."""
    raw = 16 * T * L + 8 * walk_table_size(T * L) + T
    return -(-raw // 16) * 16


def walk_shape(B: int, L: int) -> tuple[int, int, int]:
    """``(T, H, smem)`` of the walk over a batch of ``B`` transactions of
    ``L`` lines: the most transactions a tile (at most ``B``) whose shared
    memory fits ``WALK_SMEM_BUDGET``, the table entries of a full tile and
    the tile's dynamic shared memory in bytes."""
    lo, hi = 1, max(B, 1)
    while lo < hi:                     # bytes grow with T
        mid = (lo + hi + 1) // 2
        if walk_smem_bytes(mid, L) <= WALK_SMEM_BUDGET:
            lo = mid
        else:
            hi = mid - 1
    return lo, walk_table_size(lo * L), walk_smem_bytes(lo, L)


def contention_gate(avail0: torch.Tensor, slot: torch.Tensor,
                    qty: torch.Tensor, line_valid: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Level 1: ``(fast [B] bool, demand [A] int32, uncontended [A] bool)``;
    ``fast`` marks transactions whose every valid line lands on a cell with
    ``demand <= avail0``."""
    A = avail0.shape[0]
    q = torch.where(line_valid, qty, 0).to(torch.int32)
    demand = torch.zeros((A,), dtype=torch.int32, device=avail0.device)
    demand.index_put_((torch.where(line_valid, slot, 0).reshape(-1).long(),),
                      q.reshape(-1), accumulate=True)
    uncontended = demand <= avail0
    fast = (uncontended[slot.long()] | ~line_valid).all(1)
    return fast, demand, uncontended


def residual_order(fast: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Residual transaction indices first, in batch (= FCFS) order (a
    stable argsort), and ``n_res [1] int32`` — the walk's trip count, kept
    on the device."""
    res = ~fast
    res_idx = torch.argsort(torch.where(res, 0, 1), stable=True)
    return res_idx.to(torch.int32), res.sum().to(torch.int32).reshape(1)


def residual_fcfs(avail0, slot, qty, line_valid, fast, res_idx, n_res
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of Level 2: the residual walk as torch ops, one
    transaction per step (reads ``n_res`` on the host). Returns
    ``(committed, avail)`` with the kernel's contract, in a new ``avail``
    (``avail0`` is left as it was)."""
    L = slot.shape[1]
    dup_lower = torch.ones((L, L), dtype=torch.bool,
                           device=slot.device).tril(-1)
    avail = avail0.clone()
    committed = fast.clone()
    for i in range(int(n_res[0])):
        t = int(res_idx[i])
        s, q, lv = slot[t], qty[t], line_valid[t]
        same = s[None, :] == s[:, None]
        prior = torch.where(same & dup_lower & lv[None, :], q[None, :],
                            0).sum(1)
        have = avail[s.long()]
        ok = torch.where(lv, prior + q <= have, True).all()
        avail.index_put_((s.long(),), torch.where(lv & ok, -q, 0),
                         accumulate=True)
        committed[t] = ok
    return committed, avail


def settle_fast(avail, slot, qty, line_valid, fast) -> torch.Tensor:
    """Reserve the fast transactions' valid lines in ``avail`` (in place,
    one scatter; returned): with the residual walk's ``avail`` it gives the
    fully settled availability."""
    adm = line_valid & fast[:, None]
    avail.index_put_((torch.where(adm, slot, 0).reshape(-1).long(),),
                     -torch.where(adm, qty, 0).reshape(-1).to(torch.int32),
                     accumulate=True)
    return avail


def escrow_admit_cuda(avail0, slot, qty, line_valid, fast, res_idx, n_res
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Level 2 on the card: the residual walk in ``csrc/escrow_admit.cu``.
    Same arguments and result as :func:`residual_fcfs`, except that the
    kernel updates ``avail0`` in place and returns it as ``avail``: pass a
    vector the caller no longer needs (the engine builds a fresh one every
    batch). Any ``B``: the walk runs in tiles of :func:`walk_shape`.
    Launches on the current stream without synchronising;
    ``escrow_admit_cuda.launches`` counts the launches. A tensor without
    data returns the outputs unlaunched (``build.shape_only``)."""
    B, L = slot.shape
    A = avail0.shape[0]
    if L > 32:
        raise ValueError(f"escrow_admit kernel holds one line per lane: "
                         f"L={L} > 32")
    for x, name, dtype, shape in (
            (avail0, "avail0", torch.int32, (A,)),
            (slot, "slot", torch.int32, (B, L)),
            (qty, "qty", torch.int32, (B, L)),
            (line_valid, "line_valid", torch.bool, (B, L)),
            (fast, "fast", torch.bool, (B,)),
            (res_idx, "res_idx", torch.int32, (B,)),
            (n_res, "n_res", torch.int32, (1,))):
        build.check_tensor(x, name, dtype, shape)
    committed = torch.empty_like(fast)   # the kernel starts it as fast
    _mark(avail0, B, L)
    if build.shape_only(avail0):
        return committed, avail0
    fn = build.load("escrow_admit", [ctypes.c_void_p] * 8
                    + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    err = fn(n_res.data_ptr(), res_idx.data_ptr(), slot.data_ptr(),
             qty.data_ptr(), line_valid.data_ptr(), fast.data_ptr(),
             avail0.data_ptr(), committed.data_ptr(), B, L,
             *walk_shape(B, L),
             torch.cuda.current_stream(avail0.device).cuda_stream)
    build.check("escrow_admit", err)
    escrow_admit_cuda.launches += 1
    return committed, avail0


escrow_admit_cuda.launches = 0
