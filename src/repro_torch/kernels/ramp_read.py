"""The fused RAMP read — metadata check, fracture detection, lookback
select and per-query aggregation in one pass — as a hand-written CUDA
kernel (``csrc/ramp_read.cu``) beside its plain torch version.

Per query row it streams the commit-record metadata (``req_ts``,
``nlines``) and five ``[R, L]`` line streams (stamps, committed-layer
visibility, prepared-layer retention, amounts, item ids) and returns the
repaired selection with its row aggregates. Order-Status reads its line
sets through it (``txn/ramp.apply_order_status``).

Bit-exactness: every output but ``amount_sum`` is a mask, a selection or
an integer count; ``amount_sum`` adds the selected amounts in line order
from 0 in the kernel and in the plain version alike (``ref.sum_lines``).

On a tensor without data the wrapper takes its shape-only route
(``build.shape_only``); both routes count :func:`operations` to
``FlopCounterMode``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

MAX_LINES = 32   # the kernel's shared-memory tile holds at most 32 lines


def operations(R: int, L: int) -> int:
    """The float32 operations of the read: ``amount_sum``'s adds, one a
    line slot (the rest is masks and integer counts)."""
    return R * L


_mark = build.launch_marker("ramp_read", operations)


def ramp_read_plain(req_ts, nlines, ol_ts, ol_vis, ol_prep, amount, i_id):
    """The plain version of the kernel, with its contract: the oracle's
    masks and line-order sum (``ref.ramp_read_ref``). The read is one
    elementwise pass and a row sum, so it has no other plain form."""
    return ref.ramp_read_ref(req_ts, nlines, ol_ts, ol_vis, ol_prep, amount,
                             i_id)


def ramp_read_cuda(req_ts, nlines, ol_ts, ol_vis, ol_prep, amount, i_id):
    """The fused read on the card, one launch of ``csrc/ramp_read.cu``.

    req_ts/nlines [R] int32; ol_ts/i_id [R, L] int32; ol_vis/ol_prep
    [R, L] bool; amount [R, L] float32, all contiguous on one CUDA device.
    Returns (present [R, L] bool, amount_sel [R, L] float32, i_id_sel
    [R, L] int32 (-1 where absent), amount_sum [R] float32, lines_read [R]
    int32, repaired [R] int32). Launches on the current stream without
    synchronising; ``ramp_read_cuda.launches`` counts the launches. A
    tensor without data returns the outputs unlaunched
    (``build.shape_only``)."""
    R, L = ol_ts.shape
    if L > MAX_LINES:
        raise ValueError(f"ramp_read kernel holds at most {MAX_LINES} lines "
                         f"a row: L={L}")
    for x, name, dtype, shape in (
            (req_ts, "req_ts", torch.int32, (R,)),
            (nlines, "nlines", torch.int32, (R,)),
            (ol_ts, "ol_ts", torch.int32, (R, L)),
            (ol_vis, "ol_vis", torch.bool, (R, L)),
            (ol_prep, "ol_prep", torch.bool, (R, L)),
            (amount, "amount", torch.float32, (R, L)),
            (i_id, "i_id", torch.int32, (R, L))):
        build.check_tensor(x, name, dtype, shape)
    dev = ol_ts.device
    out = (torch.empty((R, L), dtype=torch.bool, device=dev),
           torch.empty((R, L), dtype=torch.float32, device=dev),
           torch.empty((R, L), dtype=torch.int32, device=dev),
           torch.empty((R,), dtype=torch.float32, device=dev),
           torch.empty((R,), dtype=torch.int32, device=dev),
           torch.empty((R,), dtype=torch.int32, device=dev))
    if R == 0:
        return out
    _mark(ol_ts, R, L)
    if build.shape_only(ol_ts):
        return out
    fn = build.load("ramp_read", [ctypes.c_void_p] * 13
                    + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p])
    ins = (req_ts, nlines, ol_ts, ol_vis, ol_prep, amount, i_id)
    err = fn(*(x.data_ptr() for x in ins), *(x.data_ptr() for x in out),
             R, L, torch.cuda.current_stream(dev).cuda_stream)
    build.check("ramp_read", err)
    ramp_read_cuda.launches += 1
    return out


ramp_read_cuda.launches = 0
