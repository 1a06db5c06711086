"""Deterministic synthetic data pipeline with coordination-free bookkeeping
— the port of ``repro.data.pipeline``.

The paper's §5.1 'choose some value' result applied to data loading:

* every (pod, data) shard owns a disjoint **sample-ID namespace**
  (id = cursor * n_shards + shard_id) — global uniqueness without any
  coordination (UNIQUENESS x ASSIGN_SOME is I-confluent);
* each shard's cursor is a monotone counter (max-join lattice) so replayed /
  merged bookkeeping converges;
* batches are a pure function of (seed, sample ids), so a restart draws
  the same global sample stream.

Tokens are Zipf-ish synthetic text, labels are next-token. The draws are
the reference's numpy code, so tokens and labels are bit-equal to its; a
batch holds host (CPU) int32 tensors, which the training loop moves to the
card. The vlm and audio families' stub embeddings seed numpy with a
string, as the reference does, which numpy refuses (``ValueError``): the
reference cannot draw such a batch from its pipeline either.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_shards: int = 1   # pod*data shards; ids are namespaced per shard


@dataclasses.dataclass
class ShardCursor:
    """Per-shard monotone cursor (max-join lattice)."""

    shard_id: int
    n_shards: int
    cursor: int = 0

    def next_ids(self, count: int) -> np.ndarray:
        ids = (np.arange(self.cursor, self.cursor + count) * self.n_shards
               + self.shard_id)
        self.cursor += count
        return ids

    @staticmethod
    def join(a: "ShardCursor", b: "ShardCursor") -> "ShardCursor":
        assert a.shard_id == b.shard_id and a.n_shards == b.n_shards
        return ShardCursor(a.shard_id, a.n_shards, max(a.cursor, b.cursor))


def _tokens_for_ids(ids: np.ndarray, cfg: DataConfig, model_cfg: ModelConfig
                    ) -> np.ndarray:
    """Pure function (seed, sample id) -> token sequence."""
    rngs = [np.random.default_rng((cfg.seed, int(i))) for i in ids]
    # Zipf-ish unigram stream, cheap and deterministic
    out = np.stack([
        (r.zipf(1.3, size=cfg.seq_len + 1) - 1).clip(0, model_cfg.vocab - 1)
        for r in rngs
    ]).astype(np.int32)
    return out


class Pipeline:
    """Host-side batch iterator for one process feeding ``n_shards`` logical
    shards (single-host simulation feeds them all)."""

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig):
        self.cfg = cfg
        self.model_cfg = model_cfg
        self.cursors = [ShardCursor(s, cfg.n_shards)
                        for s in range(cfg.n_shards)]
        if cfg.global_batch % cfg.n_shards:
            raise ValueError("global batch must divide shards")
        self.per_shard = cfg.global_batch // cfg.n_shards

    def next_batch(self) -> dict:
        ids = np.concatenate([c.next_ids(self.per_shard)
                              for c in self.cursors])
        seqs = _tokens_for_ids(ids, self.cfg, self.model_cfg)
        batch = {
            "tokens": torch.from_numpy(np.ascontiguousarray(seqs[:, :-1])),
            "labels": torch.from_numpy(np.ascontiguousarray(seqs[:, 1:])),
        }
        if self.model_cfg.family == "vlm":
            batch["image_embeds"] = self._stub_embeds(
                ids, self.model_cfg.image_tokens)
        if self.model_cfg.family == "audio":
            batch["frames"] = self._stub_embeds(ids, self.model_cfg.n_frames)
        return batch

    def _stub_embeds(self, ids: np.ndarray, n: int) -> torch.Tensor:
        """Stub frontend: deterministic pseudo patch/frame embeddings."""
        rng = np.random.default_rng((self.cfg.seed, "stub", int(ids[0])))
        x = rng.standard_normal((len(ids), n, self.model_cfg.d_model))
        return torch.from_numpy(x).to(dtype_of(self.model_cfg))

    def sample_ids_seen(self) -> set[int]:
        out: set[int] = set()
        for c in self.cursors:
            out.update(range(c.shard_id, c.cursor * c.n_shards + c.shard_id,
                             c.n_shards))
        return out

    def state(self) -> dict:
        return {"cursors": [c.cursor for c in self.cursors],
                "n_shards": self.cfg.n_shards}

    def restore(self, state: dict) -> None:
        """Restore via max-join (idempotent under replayed snapshots)."""
        for c, v in zip(self.cursors, state["cursors"]):
            c.cursor = max(c.cursor, int(v))
