"""Definitional oracles for the two kernels of the New-Order slice, as
plain torch (the port's counterparts of ``repro.kernels.ref``
``escrow_admit_ref`` and ``txn_megastep_ref``).

They are the ground truth the kernels and their plain versions are held
to: a B-step sequential FCFS walk over the whole batch, the ``[B, B]``
committed-rank matrix, and plain scatter-adds.
"""

from __future__ import annotations

import torch


def escrow_admit_ref(avail0: torch.Tensor, slot: torch.Tensor,
                     qty: torch.Tensor, line_valid: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """FCFS escrow admission: walk the batch in order; a transaction commits
    iff every valid line's quantity, plus the demand its own earlier lines
    put on the same cell, fits the cell's remaining availability; commits
    reserve, aborts leave no trace.

    avail0 [A] int32; slot/qty/line_valid [B, L].
    Returns (committed [B] bool, avail [A] int32 after all reservations).
    """
    B, L = slot.shape
    dup_lower = torch.ones((L, L), dtype=torch.bool,
                           device=slot.device).tril(-1)
    avail = avail0.clone()
    committed = torch.zeros((B,), dtype=torch.bool, device=slot.device)
    for t in range(B):
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


def txn_megastep_ref(avail0, slot, qty, line_valid, key_local, cell_local,
                     local_line, remote_line, ramp_ts, price_row, *,
                     n_keys: int, n_cells: int):
    """The megastep's definitional composition: FCFS admission
    (:func:`escrow_admit_ref`), the ``[B, B]`` committed-rank matrix,
    per-district counts, plain scatter-add stock slabs and the elementwise
    RAMP stamps.

    Returns (committed, avail, rank, d_count, stock_dec, stock_cnt,
    stock_rcnt, ol_ts, amount) — the MegastepOut tuple, field for field.
    """
    committed, avail = escrow_admit_ref(avail0, slot, qty, line_valid)
    B = qty.shape[0]
    dev = qty.device
    c32 = committed.to(torch.int32)

    same = key_local[None, :] == key_local[:, None]
    lower = torch.ones((B, B), dtype=torch.bool, device=dev).tril(-1)
    rank = (same & lower & committed[None, :]).sum(1).to(torch.int32)
    d_count = torch.zeros((n_keys,), dtype=torch.int32, device=dev)
    d_count.index_put_((key_local.long(),), c32, accumulate=True)

    m = committed[:, None] & local_line
    ids = (torch.where(m, cell_local, 0).long(),)
    slabs = []
    for vals in (torch.where(m, qty, 0), m.to(torch.int32),
                 (m & remote_line).to(torch.int32)):
        slab = torch.zeros((n_cells,), dtype=torch.int32, device=dev)
        slabs.append(slab.index_put_(ids, vals.to(torch.int32),
                                     accumulate=True))

    ol_ts = torch.where(line_valid, ramp_ts[:, None], -1).to(torch.int32)
    amount = torch.where(line_valid, price_row * qty.to(price_row.dtype),
                         0.0)
    return (committed, avail, rank, d_count, *slabs, ol_ts, amount)
