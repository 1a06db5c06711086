"""Definitional oracles for the port's kernels, as plain torch (the port's
counterparts of ``repro.kernels.ref`` ``escrow_admit_ref``,
``txn_megastep_ref``, ``ramp_read_ref``, ``lattice_merge_ref``,
``flash_attention_ref`` and ``rwkv6_scan_ref``), and the line-order sum
they and the transactions share.

They are the ground truth the kernels and their plain versions are held
to: a B-step sequential FCFS walk over the whole batch, the ``[B, B]``
committed-rank matrix, plain scatter-adds, the RAMP read's masks, the
versioned join with its threshold audit, attention as one masked softmax,
and the WKV recurrence token by token. The last two are also the plain
versions of kernels B5 and B6.
"""

from __future__ import annotations

import torch


def sum_lines(x: torch.Tensor) -> torch.Tensor:
    """``x [..., L]`` summed over the line axis IN LINE ORDER: from 0, add
    line 0, then line 1, and so on. This is the order in which XLA reduces
    a float row, so the sum is bit-equal to the reference's ``sum(-1)``;
    ``torch.sum`` reassociates (differently on the CPU and the card) and
    is not."""
    out = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for l in range(x.shape[-1]):
        out = out + x[..., l]
    return out


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


def ramp_read_ref(req_ts, nlines, ol_ts, ol_vis, ol_prep, amount, i_id):
    """Fused RAMP read oracle (``txn/ramp.read_lines`` plus the per-query
    aggregation). Round 1 reads the committed layer, the commit-record
    metadata (``req_ts``, ``nlines``) detects fractured sibling sets, and
    the lookback round repairs from the retained prepared versions.

    req_ts/nlines [R] int32; ol_ts/i_id [R, L] int32; ol_vis/ol_prep
    [R, L] bool; amount [R, L] float32. Returns (present, amount_sel,
    i_id_sel, amount_sum, lines_read, repaired).
    """
    L = ol_ts.shape[-1]
    line = torch.arange(L, dtype=torch.int32, device=ol_ts.device)[None, :]
    need = line < nlines[:, None]
    match = ol_ts == req_ts[:, None]
    round1 = ol_vis & match & need
    fractured = need & ~round1
    repaired = fractured & (ol_prep & match)
    present = round1 | repaired
    amt_sel = torch.where(present, amount, 0.0)
    return (present, amt_sel, torch.where(present, i_id, -1),
            sum_lines(amt_sel), present.sum(1).to(torch.int32),
            repaired.sum(1).to(torch.int32))


def audit_dtype(payload_dtype: torch.dtype) -> torch.dtype:
    """The dtype the threshold audit compares in: the payload's own for a
    float payload (a Python float ``lo``/``hi`` is weakly typed in JAX and
    takes the payload's dtype), float32 for an int32 payload (JAX with x64
    off promotes the pair to float32)."""
    return payload_dtype if payload_dtype.is_floating_point \
        else torch.float32


def lattice_merge_ref(a_valid, a_ver, a_pay, b_valid, b_ver, b_pay,
                      lo: float = float("-inf"), hi: float = float("inf")):
    """VersionedSlots join fused with a per-row threshold check.

    Join: ``valid = a | b``; ``version = max``; the payload of the strictly
    newer side, ``a``'s on a tie. Audit: a valid merged row is flagged
    when any payload element lies outside ``[lo, hi]``, compared in
    :func:`audit_dtype` with ``lo``/``hi`` rounded to it (so ``hi=0.1``
    flags no float32 or bfloat16 payload of ``0.1``); NaN is never
    flagged.

    a/b_valid [R] bool; a/b_ver [R] int; a/b_pay [R, W].
    Returns (valid, version, payload, violation [R] bool).
    """
    b_newer = b_ver > a_ver
    valid = a_valid | b_valid
    version = torch.maximum(a_ver, b_ver)
    payload = torch.where(b_newer[:, None], b_pay, a_pay)
    cmp = audit_dtype(payload.dtype)
    p = payload.to(cmp)
    lo_t = torch.tensor(lo, dtype=cmp, device=p.device)
    hi_t = torch.tensor(hi, dtype=cmp, device=p.device)
    bad = (p < lo_t) | (p > hi_t)
    return valid, version, payload, valid & bad.any(-1)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """GQA attention, the plain version of kernel B5 and the port of
    ``flash_attention_ref``: einsum, mask, softmax, all in float32.
    q [B, S, H, hd]; k/v [B, S, KV, hd] -> [B, S, H, hd] in q's dtype."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qh = q.reshape(B, S, KV, H // KV, hd).float()
    logits = torch.einsum("bqkgh,bskh->bkgqs", qh, k.float()) * hd ** -0.5
    if causal:
        i = torch.arange(S, device=q.device)
        logits = logits.masked_fill(i[:, None] < i[None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", probs, v.float())
    return out.reshape(B, S, H, hd).to(q.dtype)


def rwkv6_scan_plain(r, k, v, w, u, s0) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV recurrence token by token in float32, the plain version of
    kernel B6 and the port of ``rwkv6_scan_ref``, with one difference: ``w``
    is clamped below at 1e-9, as the TPU kernel clamps it (``log(max(w,
    1e-9))``); the reference's oracle does not clamp, so the two agree
    wherever ``w >= 1e-9``.

    r/k/v/w [B, T, H, hd]; u [H, hd]; s0 [B, H, hd, hd] (k rows, v
    columns). Returns (out in r's dtype, s_T float32)."""
    T = r.shape[1]
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.clamp_min(w.float(), 1e-9)
    uf = u.float()
    s = s0.float()
    outs = []
    for t in range(T):
        rt, kt, vt = rf[:, t], kf[:, t], vf[:, t]
        cur = torch.einsum("bhk,bhk->bh", rt, kt * uf[None])
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, s)
                    + cur[..., None] * vt)
        s = s * wf[:, t, ..., None] + torch.einsum("bhk,bhv->bhkv", kt, vt)
    return torch.stack(outs, 1).to(r.dtype), s
