"""Compression of the cross-pod merge — the port of
``repro.optim.compression``.

The deferred merge of the coordination plan is the only cross-pod traffic;
compressing it shrinks what crosses:

  * "none" — float32 sum over the pods, then the mean (the reference's
    ``pmean``);
  * "bf16" — an all-gather of bf16 payloads and a local float32 mean;
  * "int8" — per-leaf symmetric quantization with a scale shared by a
    ``pmax`` (one scalar a leaf), an all-gather of int8 payloads and a
    local dequantized mean (int8 cannot be summed on the wire without
    overflow, and all-gather moves exactly P x N bytes).

On one card the pods are the leading dim of every leaf (the reference's
deferred layout, ``[n_pods, ...]``, where its ``shard_map`` gives each pod
its block of the ``pod`` mesh axis). What crosses pods goes through
``txn.collectives`` (``psum``, ``all_gather``, ``pmax``), so
``collectives.counted()`` reports a merge's wire bytes as the reference's
HLO would. Every pod's slice of a merged leaf holds the same mean.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core import tree as T
from repro_torch.txn import collectives as C

PyTree = Any


def _pods(x: torch.Tensor) -> list[torch.Tensor]:
    """Each pod's block of a leaf, ``[1, ...]`` (the views tile the leaf)."""
    return [x[i:i + 1] for i in range(x.shape[0])]


def _broadcast(mean: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mean.to(like.dtype).expand_as(like).contiguous()


def pmean_tree(tree: PyTree) -> PyTree:
    def one(x):
        return _broadcast(C.psum(_pods(x)) / x.shape[0], x)
    return T.map(one, tree)


def pmean_bf16(tree: PyTree) -> PyTree:
    """bf16 on the wire via all-gather + local float32 mean."""
    def one(x):
        gathered = C.all_gather(_pods(x.to(torch.bfloat16)))
        return _broadcast(gathered.to(torch.float32).mean(0, keepdim=True),
                          x)
    return T.map(one, tree)


def pmean_int8(tree: PyTree) -> PyTree:
    """Quantize -> all_gather(int8) -> local dequantized mean."""
    def one(x):
        x32 = x.to(torch.float32)
        per_pod = x32.abs().flatten(1).amax(1)                # [P]
        scale = C.pmax(list(per_pod.unbind(0)))   # shared scale (scalar wire)
        scale = torch.clamp(scale, min=1e-12)
        q = torch.clamp(torch.round(x32 / scale * 127.0), -127, 127).to(
            torch.int8)
        gathered = C.all_gather(_pods(q))          # [P, ...] int8 on the wire
        mean = gathered.to(torch.float32).mean(0, keepdim=True) \
            * (scale / 127.0)
        return _broadcast(mean, x)
    return T.map(one, tree)


def merge_mean(tree: PyTree, compress: str) -> PyTree:
    """Every leaf ``[n_pods, ...]`` averaged over its pods, compressed as
    ``compress`` says; the result has the input's shapes and dtypes."""
    if compress == "none":
        return pmean_tree(tree)
    if compress == "bf16":
        return pmean_bf16(tree)
    if compress == "int8":
        return pmean_int8(tree)
    raise ValueError(f"unknown compression {compress!r}")
