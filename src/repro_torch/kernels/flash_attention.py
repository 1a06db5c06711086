"""Causal or full grouped-query attention with an online softmax — kernel
B5 — as a hand-written CUDA kernel (``csrc/flash_attention.cu``) beside its
plain torch version (``ref.flash_attention_plain``).

q [B, S, H, hd] and k, v [B, S, KV, hd], float32 or bfloat16, in the
reference's layout; query head h reads key/value head ``h // (H // KV)``,
and the key/value heads are never replicated. The dense serving path's
prefill runs it once per layer (``models/layers.attend`` with
``use_flash``, from ``transformer.prefill``).

Two routes, chosen by the dtype, behind the one launch entry:

* bfloat16 (what the serving path runs): the tensor-core kernel. The
  products run as bf16 ``mma.sync`` with float32 sums; the scores are
  scaled in float32, and the softmax weights P are rounded to bf16 before
  the P V product, as on any bf16 tensor-core attention.
* float32: the float32-core kernel, every product in float32. TF32 would
  keep three decimal digits and miss the reference's float32 tolerance.

This is a route by dtype, not a fallback: a bfloat16 call on the card
always launches the tensor-core kernel or raises.
``flash_attention_cuda.route_launches`` counts the launches of each route
beside ``flash_attention_cuda.launches``.

Tolerance against the plain version: the kernel sums the scores and the
weighted values in another order, takes the softmax online and (bf16)
rounds P, so the two agree to the reference's own tolerances (2e-5 in
float32, 2e-2 in bfloat16), not bit for bit.

On a tensor without data the wrapper takes its shape-only route
(``build.shape_only``); both routes count :func:`operations` to
``FlopCounterMode``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

HEAD_DIMS = (16, 32, 64, 128)   # the kernel's templates
_KIND = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.float32: "float32", torch.bfloat16: "tensor_core"}


def operations(B: int, S: int, H: int, hd: int, causal: int) -> int:
    """The multiply-adds' operations of Q K^T and P V, two a product: over
    the causal half (j <= i, the masked entries skipped) or every (i, j)
    pair."""
    return 4 * hd * B * H * (S * (S + 1) // 2 if causal else S * S)


_mark = build.launch_marker("flash_attention", operations)


def flash_attention_cuda(q, k, v, causal: bool = True) -> torch.Tensor:
    """Attention on the card, one launch of ``csrc/flash_attention.cu``.

    q [B, S, H, hd], k/v [B, S, KV, hd] of one dtype (float32 or bfloat16),
    contiguous and 16-byte aligned on one CUDA device, hd in
    :data:`HEAD_DIMS`, H a multiple of KV. Returns out [B, S, H, hd] in
    q's dtype. Launches on the current stream without synchronising;
    ``flash_attention_cuda.launches`` counts the launches and
    ``flash_attention_cuda.route_launches`` those of each route (module
    note). A tensor without data returns ``out`` unlaunched
    (``build.shape_only``)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if q.dtype not in _KIND:
        raise TypeError(f"flash_attention kernel: no {q.dtype} (float32, "
                        f"bfloat16)")
    if hd not in HEAD_DIMS or KV < 1 or H % KV:
        raise ValueError(f"flash_attention kernel: hd={hd} (want one of "
                         f"{HEAD_DIMS}), H={H}, KV={KV} (H a multiple)")
    shape_only = build.shape_only(q)
    for x, name, shape in ((q, "q", (B, S, H, hd)), (k, "k", (B, S, KV, hd)),
                           (v, "v", (B, S, KV, hd))):
        build.check_tensor(x, name, q.dtype, shape)
        if not shape_only and x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned")
    out = torch.empty_like(q)
    if B * S * H == 0:
        return out
    if B * H > 65535:
        raise ValueError(f"flash_attention kernel: B * H = {B * H} > 65535")
    _mark(q, B, S, H, hd, int(causal))
    if shape_only:
        return out
    fn = build.load("flash_attention", [ctypes.c_void_p] * 4
                    + [ctypes.c_int] * 6
                    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
             H, KV, hd, int(causal), hd ** -0.5, _KIND[q.dtype],
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check("flash_attention", err)
    flash_attention_cuda.launches += 1
    flash_attention_cuda.route_launches[ROUTES[q.dtype]] += 1
    return out


flash_attention_cuda.launches = 0
flash_attention_cuda.route_launches = dict.fromkeys(ROUTES.values(), 0)
