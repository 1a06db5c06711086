"""Serving runtime: batched generation with coordination-free bookkeeping —
the port of ``repro.runtime.serve``.

The serving plan (``core/planner.serving_state_specs``) classifies every
piece of server state; this runtime realizes it:

* request IDs — replica-namespaced (server_id ⊕ counter): unique without
  coordination (§5.1);
* admission control — an escrow token budget (§8): each server spends from
  its share, refreshed off the hot path;
* served counter — G-counter slots, read at report time.

A dense or ssm batch is one prefill over the teacher-forced prompt
prefix — kernel B5 (dense) or B6 (ssm) once per layer on the card — then
one ``decode_step`` per generated token. The reference feeds the prefix
through ``decode_step`` a token at a time. The one-pass prefill computes
the same function: every prefix position attends causally to the K/V the
cache holds for it, dequantized from int8 or cast to the activations'
dtype as the reference's ``kvc.read`` returns them, and the RWKV state is
the scan's. The two differ only in the order of float sums, not in the
function.

The moe, hybrid, vlm and audio families feed the prefix through
``decode_step`` a token at a time, as the reference does. For moe that is
a matter of the function, not of speed: the MoE drops the assignments past
an expert's capacity, which follows from the tokens dispatched together
(B at a decode step, B S in a one-pass prefill), so a one-pass prefill
would drop others and generate other tokens. The vlm's cache starts with
the cross K/V of a zero image, the audio family's with those of the
encoded zero frames (the encoder's self-attention through B5,
non-causal, on the card).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.lattice import EscrowCounter
from repro_torch.device import resolve_device, synchronize
from repro_torch.models import hymba, kv_cache, rwkv6, vlm, whisper
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of

# the families whose prompt prefix goes through decode_step a token at a time
TEACHER_FORCED = ("moe", "hybrid", "vlm", "audio")


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    capacity: int = 128          # KV capacity per sequence
    max_new_tokens: int = 16
    server_id: int = 0
    n_servers: int = 1
    admission_budget: float = 1e6  # total token budget across servers
    seed: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class BatchTiming:
    """Host wall time of one ``serve_batch``, each part ended by a device
    synchronize: the prefill (with its cache; for ``TEACHER_FORCED``
    families the prefix's decode steps) and the decode loop."""

    batch: int
    prefix: int          # tokens prefilled a sequence (P - 1)
    prefill_s: float
    decode_s: float
    steps: int           # decode steps (generated tokens a sequence)


class Server:
    """Single-logical-server static batcher on one device (the card unless
    ``device`` says otherwise); ``params`` must lie there."""

    def __init__(self, model_cfg: ModelConfig, params, cfg: ServeConfig,
                 device=None):
        self.device = resolve_device(device)
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.params = params
        self._decode = registry.make_decode_fn(model_cfg)
        self._prefill = registry.make_prefill_fn(model_cfg, cfg.capacity)
        self._next_rid = 0
        self.escrow = EscrowCounter.make(cfg.n_servers, cfg.admission_budget,
                                         device=self.device)
        self.served = np.zeros(cfg.n_servers)  # G-counter slots
        self.timings: list[BatchTiming] = []

    # -- coordination-free request admission --------------------------------

    def new_request_id(self) -> int:
        """'Choose some value' uniqueness: id = counter * n_servers + me."""
        rid = self._next_rid * self.cfg.n_servers + self.cfg.server_id
        self._next_rid += 1
        return rid

    def admit(self, prompt: np.ndarray) -> Optional[Request]:
        """Escrow admission: spend |prompt| + max_new from the local share."""
        cost = float(len(prompt) + self.cfg.max_new_tokens)
        self.escrow, ok = self.escrow.try_spend(self.cfg.server_id, cost)
        if not bool(ok):
            return None  # shed load locally; no cross-server coordination
        return Request(self.new_request_id(), prompt)

    # -- batched generation --------------------------------------------------

    def _make_cache(self, batch: int):
        cfg, dev = self.model_cfg, self.device
        if cfg.family == "ssm":
            return rwkv6.stacked_state(cfg, batch, dev)
        if cfg.family == "hybrid":
            return hymba.make_cache(cfg, batch, dev)
        if cfg.family == "vlm":
            cache = vlm.make_cache(cfg, batch, self.cfg.capacity, dev)
            img = torch.zeros(batch, cfg.image_tokens, cfg.d_model,
                              dtype=dtype_of(cfg), device=dev)
            ck, cv = vlm.build_cross_kv(self.params, img, cfg)
            return cache._replace(ck=ck.to(cache.ck.dtype),
                                  cv=cv.to(cache.cv.dtype))
        if cfg.family == "audio":
            cache = whisper.make_cache(cfg, batch, self.cfg.capacity, dev)
            frames = torch.zeros(batch, cfg.n_frames, cfg.d_model,
                                 dtype=dtype_of(cfg), device=dev)
            enc = whisper.encode(self.params, frames, cfg, use_flash=True)
            ck, cv = whisper.build_cross_kv(self.params, enc, cfg)
            return cache._replace(ck=ck.to(cache.ck.dtype),
                                  cv=cv.to(cache.cv.dtype))
        return kv_cache.make_cache(cfg, cfg.n_layers, batch,
                                   self.cfg.capacity, dev)

    def serve_batch(self, requests: list[Request]) -> list[Request]:
        """Prefill the teacher-forced prefix ``pad[:, :P-1]`` (in one pass,
        or for ``TEACHER_FORCED`` families a token at a time), then
        generate from ``pad[:, P-1]``; a simple static batch. Shorter
        prompts are padded with token 0 and fed like the rest, as in the
        reference. A dense prefix longer than the KV capacity raises."""
        B = len(requests)
        P = max(len(r.prompt) for r in requests)
        family = self.model_cfg.family
        if family == "dense" and P - 1 > self.cfg.capacity:
            raise ValueError(f"prompt prefix of {P - 1} tokens exceeds the "
                             f"KV capacity {self.cfg.capacity}")
        pad = np.zeros((B, P), np.int32)
        for i, r in enumerate(requests):
            pad[i, :len(r.prompt)] = r.prompt
        tokens = torch.from_numpy(pad).long().to(self.device)
        t0 = time.perf_counter()
        if P > 1 and family not in TEACHER_FORCED:
            _, cache = self._prefill(self.params,
                                     {"tokens": tokens[:, :P - 1]})
        else:
            cache = self._make_cache(B)
            for t in range(P - 1):
                _, cache = self._decode(self.params, cache, tokens[:, t])
        synchronize(self.device)
        t1 = time.perf_counter()
        token = tokens[:, P - 1]
        for _ in range(self.cfg.max_new_tokens):
            logits, cache = self._decode(self.params, cache, token)
            token = torch.argmax(logits, -1)
            for r, t in zip(requests, token.tolist()):
                r.generated.append(t)
        self.timings.append(BatchTiming(B, P - 1, t1 - t0,
                                        time.perf_counter() - t1,
                                        self.cfg.max_new_tokens))
        for r in requests:
            r.done = True
        self.served[self.cfg.server_id] += B
        return requests

    def report(self) -> dict:
        return {
            "served_total": float(self.served.sum()),  # G-counter read
            "escrow_remaining": float(self.escrow.remaining()),
            "server_id": self.cfg.server_id,
        }


def merge_server_bookkeeping(a: Server, b: Server) -> dict:
    """Anti-entropy between two servers' bookkeeping lattices."""
    served = np.maximum(a.served, b.served)  # G-counter slotwise max
    escrow = EscrowCounter.join(a.escrow, b.escrow)
    a.served = b.served = served
    a.escrow = b.escrow = escrow
    return {"served_total": float(served.sum()),
            "escrow_remaining": float(escrow.remaining())}
