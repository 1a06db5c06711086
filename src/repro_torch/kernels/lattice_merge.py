"""The VersionedSlots join fused with the threshold audit — kernel B4 — as a
hand-written CUDA kernel (``csrc/lattice_merge.cu``) beside its plain
torch version.

Per row of two versioned tables it ORs the valid masks, keeps the higher
stamp and the payload of the strictly newer side (``a``'s on a tie), and
flags a valid merged row with any payload element outside ``[lo, hi]``.
``VersionedSlots.join`` and ``merge_versioned_fused`` (``core/``) run it,
so the anti-entropy merges of state trees with versioned groups do.

Types: stamps int32 or int64 (the output keeps the input's; the port's
stamps are int64, where the reference's fused merge casts to int32);
payloads float32, bfloat16 or int32. The audit compares in the payload's
dtype (``ref.audit_dtype``): ``lo``/``hi`` are rounded to it on the host.
Every output is a selection, a max or a mask, so kernel and plain version
agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

_PAYLOAD_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_VERSION_BYTES = {torch.int32: 4, torch.int64: 8}


def lattice_merge_plain(a_valid, a_ver, a_pay, b_valid, b_ver, b_pay,
                        lo: float = float("-inf"), hi: float = float("inf")):
    """The plain version of the kernel, with its contract: the oracle's
    join and audit (``ref.lattice_merge_ref``). The merge is one
    elementwise pass with a row ``any``, so it has no other plain form."""
    return ref.lattice_merge_ref(a_valid, a_ver, a_pay, b_valid, b_ver, b_pay,
                                 lo, hi)


def threshold(x: float, payload_dtype: torch.dtype) -> float:
    """``x`` rounded to the dtype the audit compares in, as a float (exact
    in float32, which the kernel compares in)."""
    return float(torch.tensor(x, dtype=ref.audit_dtype(payload_dtype)))


def lattice_merge_cuda(a_valid, a_ver, a_pay, b_valid, b_ver, b_pay,
                       lo: float = float("-inf"), hi: float = float("inf")):
    """The fused join and audit on the card, one launch of
    ``csrc/lattice_merge.cu``.

    a/b_valid [R] bool; a/b_ver [R] int32 or int64 (one dtype); a/b_pay
    [R, W] float32, bfloat16 or int32 (one dtype), all contiguous on one
    CUDA device. Returns (valid [R] bool, version [R], payload [R, W],
    violation [R] bool). Raises ``TypeError`` for another payload or
    stamp dtype. Launches on the current stream without synchronising;
    ``lattice_merge_cuda.launches`` counts the launches."""
    if a_pay.ndim != 2:
        raise ValueError(f"lattice_merge: payload must be [R, W], got "
                         f"{tuple(a_pay.shape)}")
    if a_pay.dtype not in _PAYLOAD_KIND:
        raise TypeError(f"lattice_merge kernel: no {a_pay.dtype} payload "
                        f"(float32, bfloat16, int32)")
    if a_ver.dtype not in _VERSION_BYTES:
        raise TypeError(f"lattice_merge kernel: no {a_ver.dtype} stamps "
                        f"(int32, int64)")
    R, W = a_pay.shape
    for x, name, dtype, shape in (
            (a_valid, "a_valid", torch.bool, (R,)),
            (a_ver, "a_ver", a_ver.dtype, (R,)),
            (a_pay, "a_pay", a_pay.dtype, (R, W)),
            (b_valid, "b_valid", torch.bool, (R,)),
            (b_ver, "b_ver", a_ver.dtype, (R,)),
            (b_pay, "b_pay", a_pay.dtype, (R, W))):
        build.check_tensor(x, name, dtype, shape)
    dev = a_pay.device
    out = (torch.empty((R,), dtype=torch.bool, device=dev),
           torch.empty((R,), dtype=a_ver.dtype, device=dev),
           torch.empty((R, W), dtype=a_pay.dtype, device=dev),
           torch.empty((R,), dtype=torch.bool, device=dev))
    if R == 0:
        return out
    row_bytes = W * a_pay.element_size()
    vec = row_bytes % 16 == 0 and all(
        p.data_ptr() % 16 == 0 for p in (a_pay, b_pay, out[2]))
    fn = build.load("lattice_merge", [ctypes.c_void_p] * 10
                    + [ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p])
    ins = (a_valid, a_ver, a_pay, b_valid, b_ver, b_pay)
    err = fn(*(x.data_ptr() for x in ins), *(x.data_ptr() for x in out),
             R, W, threshold(lo, a_pay.dtype), threshold(hi, a_pay.dtype),
             _VERSION_BYTES[a_ver.dtype], _PAYLOAD_KIND[a_pay.dtype],
             int(vec), torch.cuda.current_stream(dev).cuda_stream)
    build.check("lattice_merge", err)
    lattice_merge_cuda.launches += 1
    return out


lattice_merge_cuda.launches = 0
