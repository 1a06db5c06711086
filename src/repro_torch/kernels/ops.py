"""Public entries for the port's six kernels.

Each entry sends the problem where its tensors lie: a CPU tensor goes to
the plain torch version, a CUDA tensor to the hand-written kernel. There
is no other path. A tensor without data (meta, or fake under
``FakeTensorMode``) goes to the kernel's wrapper too, which returns the
kernel's outputs without building or launching it (``build.shape_only``);
B4's entry keeps to the CPU/CUDA split: no traced path reaches it. The
two admission entries run the contention gate as torch ops first; on the
card their kernels update ``avail0`` in place, so callers pass a vector
they no longer need (the engine builds a fresh one every batch).
"""

from __future__ import annotations

import torch

from . import build, ref
from .escrow_admit import (contention_gate, escrow_admit_cuda, residual_fcfs,
                           residual_order, settle_fast)
from .flash_attention import flash_attention_cuda
from .lattice_merge import lattice_merge_cuda, lattice_merge_plain
from .ramp_read import ramp_read_cuda, ramp_read_plain
from .rwkv6_scan import rwkv6_scan_cuda
from .txn_megastep import MegastepOut, txn_megastep_cuda, txn_megastep_plain


def escrow_admit(avail0, slot, qty, line_valid
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-level escrow admission: the gate, the residual FCFS walk, and one
    scatter that settles the fast path's reservations. Bit-exact with the
    sequential scan (``ref.escrow_admit_ref``).

    avail0 [A] int32; slot/qty/line_valid [B, L].
    Returns (committed [B] bool, avail [A] int32 after all reservations).

    An all-fast batch is not a separate branch: its walk has ``n_res == 0``
    and the settle scatter alone gives ``avail0 - demand``.
    """
    fast, _, _ = contention_gate(avail0, slot, qty, line_valid)
    res_idx, n_res = residual_order(fast)
    walk = escrow_admit_cuda if build.takes_kernel(avail0) \
        else residual_fcfs
    committed, avail = walk(avail0, slot, qty, line_valid, fast, res_idx,
                            n_res)
    return committed, settle_fast(avail, slot, qty, line_valid, fast)


def txn_megastep(avail0, slot, qty, line_valid, key_local, cell_local,
                 local_line, remote_line, ramp_ts, price_row, *,
                 n_keys: int, n_cells: int) -> MegastepOut:
    """The transaction megastep: the gate, then phases 2-4 (residual FCFS,
    committed effects, RAMP stamps). Bit-exact with ``ref.txn_megastep_ref``.
    On the card one kernel runs phases 2-4 and settles ``avail`` itself;
    on the CPU its plain version (``txn_megastep_plain``) runs."""
    fast, _, _ = contention_gate(avail0, slot, qty, line_valid)
    res_idx, n_res = residual_order(fast)
    mega = txn_megastep_cuda if build.takes_kernel(avail0) \
        else txn_megastep_plain
    return mega(avail0, slot, qty, line_valid, fast, res_idx, n_res,
                key_local, cell_local, local_line, remote_line, ramp_ts,
                price_row, n_keys=n_keys, n_cells=n_cells)


def ramp_read_select(req_ts, nlines, ol_ts, ol_vis, ol_prep, amount, i_id
                     ) -> tuple[torch.Tensor, ...]:
    """The fused RAMP read: fracture detection, lookback select and the
    per-query aggregation. Bit-exact with ``ref.ramp_read_ref``; on the card
    one kernel (``ramp_read_cuda``), on the CPU its plain version.

    Returns (present, amount_sel, i_id_sel, amount_sum, lines_read,
    repaired)."""
    read = ramp_read_cuda if build.takes_kernel(ol_ts) else ramp_read_plain
    return read(req_ts, nlines, ol_ts, ol_vis, ol_prep, amount, i_id)


def lattice_merge(a_valid, a_ver, a_pay, b_valid, b_ver, b_pay,
                  lo: float = float("-inf"), hi: float = float("inf")
                  ) -> tuple[torch.Tensor, ...]:
    """The VersionedSlots join fused with the threshold audit. Bit-exact
    with ``ref.lattice_merge_ref``; on the card one kernel
    (``lattice_merge_cuda``), on the CPU its plain version.

    Returns (valid, version, payload, violation)."""
    merge = lattice_merge_cuda if a_pay.is_cuda else lattice_merge_plain
    return merge(a_valid, a_ver, a_pay, b_valid, b_ver, b_pay, lo, hi)


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """GQA attention with an online softmax. q [B, S, H, hd]; k/v
    [B, S, KV, hd] -> [B, S, H, hd]. On the card one kernel
    (``flash_attention_cuda``: bf16 on the tensor cores, float32 on the
    float32 cores), which takes any S (the reference's wrapper
    halves its blocks until they divide S); on the CPU its plain version
    (``ref.flash_attention_plain``)."""
    attend = flash_attention_cuda if build.takes_kernel(q) \
        else ref.flash_attention_plain
    return attend(q, k, v, causal=causal)


def rwkv6_scan(r, k, v, w, u, s0) -> tuple[torch.Tensor, torch.Tensor]:
    """The RWKV-6 WKV scan. Returns (out, final state). On the card one
    kernel (``rwkv6_scan_cuda``, the chunked form), which takes any T (the
    reference's wrapper shrinks its chunk to a divisor of T); on the CPU
    its plain version (``ref.rwkv6_scan_plain``)."""
    scan = rwkv6_scan_cuda if build.takes_kernel(r) else ref.rwkv6_scan_plain
    return scan(r, k, v, w, u, s0)
