"""Crash-safe run recovery: engine state + escrow + retry ring as ONE
tree, the port of ``repro.txn.recovery``.

* :func:`save_run` bundles the escrow-regime run image — ``TPCCState``,
  the escrow shares/spent and the cold-retry ring — into one checkpoint
  tree and pushes it through the manifest-lattice layer
  (``repro_torch.ckpt.checkpoint``): coordination-free shard writes, a
  temp-id manifest, then the atomic ``assign_sequential`` commit. A crash
  at any point of the save leaves ``latest_manifest`` returning the
  previous committed checkpoint.
* :func:`restore_run` rebuilds that tree from the newest recoverable
  manifest, every leaf on the engine's device, so a run resumes through
  ``txn.drivers.run_loop(engine, r.state, r.esc, retry=r.retry, ...)``.

The retry ring IS run state: its pending owner-rejected cold entries are
neither applied nor finally rejected yet, so a checkpoint without it would
lose them or apply them twice. Saving a run made with
``run_loop(..., final_flush=False, return_retry=True)`` keeps the ledger
(optimistic admits == applied + final rejects) exact across a restart.
The escrow shares could be re-derived from the stock by a refresh; the
checkpoint stores them so a restore is bit-identical to the saved image.

The files are the reference's, leaf names included (``state/.s_quantity``,
``esc/.shares``, ``retry/.dst_w``): a run either package saves restores in
the other.
"""

from __future__ import annotations

import os
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.core.lattice import EscrowCounter, HotSetEscrow

from . import tpcc

__all__ = ["RestoredRun", "save_run", "restore_run"]


class RestoredRun(NamedTuple):
    """restore_run's result: the run image + where it came from."""

    state: tpcc.TPCCState
    esc: Any                 # HotSetEscrow | EscrowCounter | None
    retry: Any               # tpcc.RetryState | None
    step: int                # manifest step (drain-window index at save)
    manifest: ckpt.Manifest


def save_run(directory: str, state: tpcc.TPCCState, step: int, *,
             esc=None, retry=None, writer: str = "w0",
             commit: bool = True) -> ckpt.Manifest:
    """Checkpoint the run image through the manifest lattice.

    Writes the shard file + temp manifest (coordination-free), then — when
    ``commit`` — runs the atomic sequential-ID commit. ``commit=False``
    models a writer that dies before the commit step: the temp manifest is
    on disk and joinable, but ``latest_manifest`` still prefers the last
    committed generation.
    """
    tree: dict[str, Any] = {"state": state}
    if esc is not None:
        tree["esc"] = esc
    if retry is not None:
        tree["retry"] = retry
    man = ckpt.save(directory, tree, step, writer=writer)
    if commit:
        man = ckpt.assign_sequential(directory, man)
    return man


def _peek_shape(directory: str, man: ckpt.Manifest, name: str) -> tuple:
    """Shape of one saved leaf without materializing the whole file —
    the retry ring's capacity is a save-time choice, not an engine
    attribute, so restore recovers it from the checkpoint itself."""
    with np.load(os.path.join(directory, man.shards[name])) as z:
        return tuple(z[name.replace("/", "__")].shape)


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _engine_escrow_abstract(engine) -> Any:
    """The engine's escrow layout as meta tensors: the sparse ``[K]`` keys
    and ``[R, K]`` shares and spent, or the dense ``[R, W, I]`` ones."""
    R = engine.n_shards
    if engine.escrow_layout == "sparse":
        K = engine.hot_keys.shape[0]
        return HotSetEscrow(_meta((K,)), _meta((R, K)), _meta((R, K)))
    W, I = engine.scale.n_warehouses, engine.scale.n_items
    return EscrowCounter(_meta((R, W, I)), _meta((R, W, I)))


def restore_run(directory: str, engine=None, *,
                manifest: Optional[ckpt.Manifest] = None
                ) -> Optional[RestoredRun]:
    """Rebuild a :func:`save_run` image from the newest recoverable manifest.

    With ``engine`` given, every leaf lands on the engine's device (the
    state whole, the escrow rows and the ``[n_shards, C]`` rings as one
    tensor each, on the replica dim); ``engine=None`` restores host (CPU)
    tensors, recovering the scale from the saved shapes. Returns ``None``
    when the directory holds no recoverable manifest at all; raises when
    the newest manifest is incomplete (a partial writer set is detectable,
    not silently restorable).
    """
    man = manifest if manifest is not None else ckpt.latest_manifest(directory)
    if man is None:
        return None
    names = set(man.shards)

    if engine is not None:
        abstract: dict[str, Any] = {
            "state": tpcc.state_shape_dtypes(engine.scale)}
        device = engine.device
    else:
        # host-side restore: no engine to ask for the scale, so recover it
        # from the saved array shapes themselves
        if not any(n.startswith("state/") for n in names):
            raise ValueError("manifest has no state leaves")
        abstract = {"state": tpcc.state_shape_dtypes(
            _scale_from_saved(directory, man))}
        device = "cpu"

    if any(n.startswith("esc/") for n in names):
        abstract["esc"] = (_engine_escrow_abstract(engine)
                           if engine is not None
                           else _escrow_abstract(directory, man, names))

    retry_names = sorted(n for n in names if n.startswith("retry/"))
    if retry_names:
        shape = _peek_shape(directory, man, retry_names[0])
        i32, b = _meta(shape), _meta(shape, torch.bool)
        abstract["retry"] = tpcc.RetryState(i32, i32, i32, i32, b, b)

    if not ckpt.is_complete(man, abstract):
        missing = ({n for n, _ in ckpt._flatten_with_names(abstract)}
                   - names)
        raise ValueError(f"manifest {man.temp_id or man.seq_id} is "
                         f"incomplete: missing {sorted(missing)[:4]}...")
    out = ckpt.restore(directory, man, abstract, device)
    return RestoredRun(out["state"], out.get("esc"), out.get("retry"),
                       int(man.step), man)


def _scale_from_saved(directory: str, man: ckpt.Manifest) -> tpcc.TPCCScale:
    """Recover the TPCCScale from saved array shapes (host-side restore has
    no engine to ask): s_quantity -> [W, I], ol_qty -> [W, D, OC, L],
    customers from c_balance."""
    by_name = {}
    for name in man.shards:
        if name.startswith("state/"):
            by_name[name] = _peek_shape(directory, man, name)

    def shape_of(field):
        # NamedTuple fields are named ".field" by the checkpoint layer
        for key in (f"state/.{field}", f"state/{field}"):
            if key in by_name:
                return by_name[key]
        raise KeyError(field)
    W, I = shape_of("s_quantity")
    _, D, C = shape_of("c_balance")
    _, _, OC, L = shape_of("ol_qty")
    return tpcc.TPCCScale(n_warehouses=W, districts=D, customers=C,
                          n_items=I, order_capacity=OC, max_lines=L)


def _escrow_abstract(directory: str, man: ckpt.Manifest, names) -> Any:
    """Abstract escrow tree from saved shapes (host-side restore)."""
    esc_names = sorted(n for n in names if n.startswith("esc/"))
    if len(esc_names) == 3:          # HotSetEscrow(keys, shares, spent)
        shapes = {n: _peek_shape(directory, man, n) for n in esc_names}
        one_d = [n for n in esc_names if len(shapes[n]) == 1]
        two_d = [n for n in esc_names if len(shapes[n]) == 2]
        if len(one_d) == 1 and len(two_d) == 2:
            return HotSetEscrow(_meta(shapes[one_d[0]]),
                                _meta(shapes[two_d[0]]),
                                _meta(shapes[two_d[1]]))
    shapes = [_peek_shape(directory, man, n) for n in esc_names]
    return EscrowCounter(_meta(shapes[0]), _meta(shapes[1]))
