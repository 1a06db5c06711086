"""Checkpointing with lattice manifests: the port of
``repro.ckpt.checkpoint``, in its on-disk format bit for bit.

* **Shard files** — each writer saves its leaves with one ``np.savez``,
  keys the leaf names with ``/`` replaced by ``__``, no barrier
  (coordination-free writes).
* **Manifest lattice** — ``shards`` a grow-only set of (name, file)
  entries, ``step`` a max-join, ``writer_meta`` a slot per writer. Two
  half-written manifests of one checkpoint MERGE into a valid one; a
  checkpoint is *complete* when the merged shard set covers the state tree.
* **Sequential checkpoint IDs** — writers tag checkpoints with random
  temporary IDs; :func:`assign_sequential`, the one assigner, commits the
  dense ID (``ckpt-NNNNNN.manifest.json`` beside a ``SEQUENCE`` counter),
  both written through a temporary file and ``os.replace``.
* **Restore** — arrays are stored whole (the host view); :func:`restore`
  puts every leaf on the device it is given.

Leaf names are the reference's: a dict key names its value, a NamedTuple
field ``f`` is ``.f``, a list or tuple item its index, joined with ``/``
(``{"state": TPCCState}`` saves ``s_quantity`` as ``state/.s_quantity``),
so a checkpoint either package writes restores in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import uuid
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import tree as T

PyTree = Any


# ---------------------------------------------------------------------------
# Manifest lattice
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Manifest:
    step: int = 0
    temp_id: str = ""                 # replica-namespaced (uuid) — unique
    seq_id: Optional[int] = None      # assigned at commit (deferred, dense)
    shards: dict = dataclasses.field(default_factory=dict)  # name -> file
    writer_meta: dict = dataclasses.field(
        default_factory=dict)                                  # writer -> info

    @staticmethod
    def join(a: "Manifest", b: "Manifest") -> "Manifest":
        assert a.temp_id == b.temp_id or not (a.temp_id and b.temp_id)
        return Manifest(
            step=max(a.step, b.step),
            temp_id=a.temp_id or b.temp_id,
            seq_id=a.seq_id if a.seq_id is not None else b.seq_id,
            shards={**a.shards, **b.shards},          # grow-only set union
            writer_meta={**a.writer_meta, **b.writer_meta},
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "Manifest":
        return Manifest(**json.loads(s))


def _flatten_with_names(tree: PyTree) -> list[tuple[str, Any]]:
    """``(name, leaf)`` in the reference's leaf order (dict keys sorted),
    named as ``jax.tree_util`` paths stringify; a bare leaf is ``leaf``."""
    out: list[tuple[str, Any]] = []

    def walk(x, path):
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], path + [str(k)])
        elif hasattr(x, "_fields"):
            for f, v in zip(x._fields, x):
                walk(v, path + [f".{f}"])
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, path + [str(i)])
        elif hasattr(x, "tree_flatten") and hasattr(x, "tree_unflatten"):
            for i, v in enumerate(x.tree_flatten()[0]):
                walk(v, path + [str(i)])
        else:
            out.append(("/".join(path) or "leaf", x))

    walk(tree, [])
    return out


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


# ---------------------------------------------------------------------------
# Save / restore
# ---------------------------------------------------------------------------


def save(directory: str, state: PyTree, step: int, *,
         writer: str = "w0", partial: Optional[set] = None) -> Manifest:
    """Write state shards + a manifest. ``partial`` restricts to a subset of
    leaf names (simulating one of several concurrent writers)."""
    os.makedirs(directory, exist_ok=True)
    temp_id = f"ckpt-{uuid.uuid4().hex[:12]}"
    man = Manifest(step=step, temp_id=temp_id)
    arrays = {}
    for name, leaf in _flatten_with_names(state):
        if partial is not None and name not in partial:
            continue
        key = name.replace("/", "__")
        arrays[key] = _host(leaf)
        man.shards[name] = f"{temp_id}-{writer}.npz"
    np.savez(os.path.join(directory, f"{temp_id}-{writer}.npz"), **arrays)
    man.writer_meta[writer] = {"time": time.time(), "n_shards": len(arrays)}
    with open(os.path.join(directory, f"{temp_id}-{writer}.manifest.json"),
              "w") as f:
        f.write(man.to_json())
    return man


def merge_manifests(mans: list[Manifest]) -> Manifest:
    out = mans[0]
    for m in mans[1:]:
        out = Manifest.join(out, m)
    return out


def is_complete(man: Manifest, state_tree: PyTree) -> bool:
    """The manifest invariant: every leaf of the state tree is covered."""
    needed = {name for name, _ in _flatten_with_names(state_tree)}
    return needed.issubset(set(man.shards))


def _write_atomic(path: str, payload: str) -> None:
    """All-or-nothing file write: temp file in the same directory, fsync,
    then ``os.replace`` — a crash at any point leaves either the previous
    contents or the new ones, never a truncated file."""
    tmp = f"{path}.tmp-{uuid.uuid4().hex[:8]}"
    with open(tmp, "w") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _max_committed_id(directory: str) -> int:
    """Highest dense ID among committed manifests on disk (-1 if none) —
    the recovery source of truth when SEQUENCE itself was lost or corrupted
    by a pre-atomic-write crash."""
    ids = [int(f[5:11]) for f in os.listdir(directory)
           if f.startswith("ckpt-") and f.endswith(".manifest.json")
           and f[5:11].isdigit() and f[11:12] == "."]
    return max(ids, default=-1)


def assign_sequential(directory: str, man: Manifest) -> Manifest:
    """Commit-time dense ID assignment (TPC-C district-counter strategy):
    one assigner reads the current max sequence and increments it (single
    writer; everyone else only ever uses temp IDs). Both the SEQUENCE
    counter and the committed manifest are written via temp file +
    ``os.replace``, so a crash mid-commit never leaves a truncated file for
    ``latest_manifest`` to trip over."""
    seq_path = os.path.join(directory, "SEQUENCE")
    current = -1
    if os.path.exists(seq_path):
        with open(seq_path) as f:
            try:
                current = int(f.read().strip() or -1)
            except ValueError:
                # a truncated SEQUENCE: recover the counter from the
                # committed manifests themselves
                current = _max_committed_id(directory)
    new_id = current + 1
    _write_atomic(seq_path, str(new_id))
    man = dataclasses.replace(man, seq_id=new_id)
    _write_atomic(
        os.path.join(directory, f"ckpt-{new_id:06d}.manifest.json"),
        man.to_json())
    return man


def restore(directory: str, man: Manifest, abstract: PyTree,
            device="cpu") -> PyTree:
    """Rebuild the tree of ``abstract`` (tensors, meta tensors included,
    giving each leaf's dtype) from the files ``man`` names, every leaf cast
    to its template's dtype and put on ``device`` (default: host memory)."""
    files: dict[str, list[str]] = {}
    for name, fname in man.shards.items():
        files.setdefault(fname, []).append(name)
    loaded = {}
    for fname, names in files.items():
        with np.load(os.path.join(directory, fname)) as z:
            for name in names:
                loaded[name] = z[name.replace("/", "__")]

    dev = torch.device(device)
    leaves = []
    for name, leaf in _flatten_with_names(abstract):
        t = torch.from_numpy(loaded[name])
        if t.dtype != leaf.dtype:
            t = t.to(leaf.dtype)
        leaves.append(t.to(dev))
    return T.unflatten(T.flatten(abstract)[1], leaves)


def _load_manifest(path: str) -> Optional[Manifest]:
    """Parse a manifest file, returning None on any corruption (truncated
    JSON, wrong fields) instead of raising — recovery must degrade to an
    older checkpoint, not crash on a half-written file."""
    try:
        with open(path) as f:
            return Manifest.from_json(f.read())
    except (json.JSONDecodeError, TypeError, ValueError, OSError):
        return None


def _temp_time(man: Manifest, path: str) -> float:
    """Ordering key for temp manifests: the newest writer_meta timestamp,
    falling back to file mtime — temp ids are random uuid hex, so filename
    order is meaningless."""
    times = [m.get("time") for m in man.writer_meta.values()
             if isinstance(m, dict)
             and isinstance(m.get("time"), (int, float))]
    if times:
        return float(max(times))
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0.0


def latest_manifest(directory: str) -> Optional[Manifest]:
    """Newest committed (sequentially-named) manifest, else the newest temp
    generation (its writers' manifests joined).

    Unparseable committed manifests are skipped: recovery falls back to the
    previous committed checkpoint, never raises on a corrupt one. A
    committed name is exactly ``ckpt-NNNNNN.manifest.json`` (the dot right
    after the six digits), so a temp id that begins with six digits never
    shadows a committed manifest."""
    committed = sorted(f for f in os.listdir(directory)
                       if f.startswith("ckpt-")
                       and f.endswith(".manifest.json")
                       and f[5:11].isdigit() and f[11:12] == ".")
    for fname in reversed(committed):
        man = _load_manifest(os.path.join(directory, fname))
        if man is not None:
            return man
    temps = [f for f in os.listdir(directory)
             if f.endswith(".manifest.json") and f not in set(committed)]
    parsed = []
    for t in temps:
        path = os.path.join(directory, t)
        man = _load_manifest(path)
        if man is not None:
            parsed.append((_temp_time(man, path), man))
    if not parsed:
        return None
    parsed.sort(key=lambda p: p[0])
    newest_id = parsed[-1][1].temp_id
    same = [m for _, m in parsed if m.temp_id == newest_id]
    return merge_manifests(same)
