"""The RWKV-6 WKV scan with data-dependent decay ``w`` and bonus ``u`` —
kernel B6 — as a hand-written CUDA kernel (``csrc/rwkv6_scan.cu``) beside
its plain torch version (``ref.rwkv6_scan_plain``).

r/k/v [B, T, H, hd] float32 or bfloat16; w [B, T, H, hd], u [H, hd] and
s0 [B, H, hd, hd] float32. Returns (out [B, T, H, hd] in r's dtype, s_T
[B, H, hd, hd] float32). The RWKV serving path's prefill runs it once per
layer (``models/rwkv6.time_mix_apply`` with ``use_kernel``, from
``rwkv6.forward``).

Both clamp ``w`` below at 1e-9, as the TPU kernel clamps it. The plain
version walks the per-token recurrence; the kernel takes the TPU kernel's
chunked form (chunks of 16 tokens, the decays masked inside the exponent),
which is the same function. Tolerance against the plain version: the
kernel sums in another order and through the chunk's cumulative decays,
so the two agree to rounding (the reference's ``tests/test_kernels.py``
tolerances), not bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIMS = (8, 16, 32, 64, 128)   # the kernel's templates
CHUNK = 16                         # tokens a chunk (csrc/rwkv6_scan.cu)
_KIND = {torch.float32: 0, torch.bfloat16: 1}


def rwkv6_scan_cuda(r, k, v, w, u, s0) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan on the card, one launch of ``csrc/rwkv6_scan.cu``.

    Shapes and dtypes as in the module's note, every tensor contiguous on
    one CUDA device, hd in :data:`HEAD_DIMS`. Launches on the current
    stream without synchronising; ``rwkv6_scan_cuda.launches`` counts the
    launches."""
    B, T, H, hd = r.shape
    if r.dtype not in _KIND:
        raise TypeError(f"rwkv6_scan kernel: no {r.dtype} r/k/v (float32, "
                        f"bfloat16)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan kernel: hd={hd} (want one of "
                         f"{HEAD_DIMS})")
    for x, name, dtype, shape in (
            (r, "r", r.dtype, (B, T, H, hd)), (k, "k", r.dtype, (B, T, H, hd)),
            (v, "v", r.dtype, (B, T, H, hd)),
            (w, "w", torch.float32, (B, T, H, hd)),
            (u, "u", torch.float32, (H, hd)),
            (s0, "s0", torch.float32, (B, H, hd, hd))):
        build.check_tensor(x, name, dtype, shape)
    out = torch.empty_like(r)
    s_T = torch.empty_like(s0)
    if B * H == 0:
        return out, s_T
    fn = build.load("rwkv6_scan", [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                    + [ctypes.c_void_p])
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = fn(*(x.data_ptr() for x in (r, k, v, w, u, s0, out, s_T)), B, T, H,
             hd, _KIND[r.dtype], stream)
    build.check("rwkv6_scan", err)
    rwkv6_scan_cuda.launches += 1
    return out, s_T


rwkv6_scan_cuda.launches = 0
