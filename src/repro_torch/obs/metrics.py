"""The on-device metrics lattice of the fused executor (the port of
``repro.obs.metrics``).

Every metric is a lattice of ``core.lattice``: :class:`CounterLattice`
per-replica counters and :class:`HistogramLattice` histograms over fixed
log2-spaced bins, so recording is a local monotone add and merging is the
join. The executor records nothing in its timed loop: the joins commute,
so the per-chunk :func:`record_chunk` folds run after the wall clock
stops, then one :func:`fold_counters`, and give what recording inline
would. The captured chunk of the merge regime is the metrics-off graph;
in the escrow regime the graph also writes each step's commit mask into
a fixed buffer (``txn/executor.py``). No host read during the run, no
collective, one device-to-host copy at its end (:func:`metrics_to_host`).

Metrics are write-only: nothing in the transaction path reads them, so a
metrics-on run ends bit-equal to a metrics-off run.

What a chunk records:

* **latency-proxy histograms, per transaction type** — the visibility lag
  in steps: a transaction whose effects are all home-local is visible at
  the end of its own step (proxy 1); a New-Order with a remote line only
  at the chunk's drain (proxy ``1 + T - t`` for step ``t`` of ``T``). The
  snapshot converts steps to seconds with the run's wall time a step.
* **per-replica abort and cold-reject counters** — escrow aborts (from
  the counters) and owner-side cold rejects (one :func:`add_cold_rejects`
  a drain).
* **item access** — per-replica demand over the whole item keyspace,
  every attempted valid order line (aborted demand too).

Lane ``r`` of every leaf is shard ``r``'s: a global batch of ``R * B``
transactions gives lane ``r`` its block ``r``, as the reference's
``shard_map`` gives each shard its lane 0. At one shard the recorders are
the reference's functions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.lattice import CounterLattice, HistogramLattice

# the transaction-type axis of the latency histogram (its order is part of
# the snapshot schema, "repro.obs/1")
TXN_TYPES = ("neworder", "payment", "order_status", "stock_level", "delivery")
N_TXN_TYPES = len(TXN_TYPES)
_NEWORDER, _PAYMENT, _ORDER_STATUS, _STOCK_LEVEL, _DELIVERY = range(5)

# fixed log2-spaced latency-proxy bins: bin 0 holds proxy < 2 steps, the
# open top bin anything >= 2**14
OBS_BINS = 16

# the item-access record builds a lines x keyspace one-hot up to this many
# elements a lane, and scatters (``index_add_``, exact on integers) above
_ONE_HOT_MAX_ELEMS = 1 << 20


class ObsMetrics(NamedTuple):
    """The metrics on the device, one lane a shard."""

    latency: HistogramLattice     # counts [R, N_TXN_TYPES, OBS_BINS]
    aborts: CounterLattice        # [R] escrow insufficient-share aborts
    cold_rejects: CounterLattice  # [R] owner-rejected cold-tier entries
    item_access: CounterLattice   # [R, n_items] attempted order-line demand


def make_obs_metrics(num_replicas: int, n_items: int,
                     device=None) -> ObsMetrics:
    """Empty metrics, on the card unless ``device`` says otherwise."""
    return ObsMetrics(
        latency=HistogramLattice.make(num_replicas, OBS_BINS,
                                      extra_shape=(N_TXN_TYPES,),
                                      device=device),
        aborts=CounterLattice.make(num_replicas, device=device),
        cold_rejects=CounterLattice.make(num_replicas, device=device),
        item_access=CounterLattice.make(num_replicas, (n_items,),
                                        device=device))


def obs_metrics_join(a: ObsMetrics, b: ObsMetrics) -> ObsMetrics:
    """Leafwise join (merging snapshots across runs or replicas)."""
    return ObsMetrics(HistogramLattice.join(a.latency, b.latency),
                      CounterLattice.join(a.aborts, b.aborts),
                      CounterLattice.join(a.cold_rejects, b.cold_rejects),
                      CounterLattice.join(a.item_access, b.item_access))


def init_obs_metrics(engine) -> ObsMetrics:
    """The engine's metrics, every leaf its own buffer on
    ``engine.device``."""
    return make_obs_metrics(engine.n_shards, engine.scale.n_items,
                            device=engine.device)


# ---------------------------------------------------------------------------
# Recorders. Every metric is a function of the chunk's inputs (item demand,
# remote-line visibility lag), of its commit mask, or of totals the chunk
# already keeps in MixCounters, so the lattice is fed after the chunks ran:
# record_chunk once a chunk, add_cold_rejects once a drain, fold_counters
# once a run. Each returns new tensors and reads nothing of the run's
# state. The adds are integer, exact in any order.
# ---------------------------------------------------------------------------


def _lanes(x: torch.Tensor, R: int) -> torch.Tensor:
    """``[T, R * B, ...]`` -> ``[R, T, B, ...]``: lane r, block r."""
    T, RB = x.shape[:2]
    return x.reshape(T, R, RB // R, *x.shape[2:]).transpose(0, 1)


def _bin_counts(hist: HistogramLattice, values: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    """Per-bin weight totals of each lane's observations: values and
    weights ``[R, ...]`` -> ``[R, n_bins]``."""
    R = values.shape[0]
    bins = hist.bin_of(values.reshape(R, -1))
    onehot = bins[..., None] == torch.arange(hist.n_bins,
                                             device=bins.device)
    return (onehot * weights.reshape(R, -1, 1)).sum(dim=1)


def record_chunk(m: ObsMetrics, no_batch, ok: torch.Tensor | None
                 ) -> ObsMetrics:
    """Fold one executed chunk's input-determined metrics into the lattice.

    ``no_batch`` is the chunk's stacked New-Order input (``[T, R * B,
    ...]``, lane r block r); ``ok`` its per-step commit mask ``[T, R *
    B]`` (None in the merge regime, where every New-Order commits).
    Records the New-Order latency-proxy histogram (committed-weighted) and
    the attempted item demand; the other totals come through
    :func:`fold_counters`."""
    T, RB, L = no_batch.i_id.shape
    R = m.latency.counts.shape[0]
    dev = m.latency.counts.device
    dtype = m.latency.counts.dtype
    line_valid = (torch.arange(L, device=dev)[None, None, :]
                  < no_batch.n_lines[..., None])
    is_remote = (line_valid
                 & (no_batch.supply_w != no_batch.w[..., None])).any(dim=-1)
    # visibility lag: its own step for a local transaction, plus the steps
    # to the chunk's drain (after step T-1) for a remote one
    steps = torch.arange(T, dtype=torch.int32, device=dev)[:, None]
    proxy = torch.where(is_remote, 1 + T - steps,
                        torch.ones_like(steps))
    committed = (torch.ones((T, RB), dtype=dtype, device=dev) if ok is None
                 else ok.to(dtype))
    counts = m.latency.counts.clone()
    counts[:, _NEWORDER] += _bin_counts(m.latency, _lanes(proxy, R),
                                        _lanes(committed, R)).to(dtype)
    latency = m.latency._replace(counts=counts)

    # attempted item demand (aborted demand is contention signal too)
    slots = m.item_access.slots
    n_items = slots.shape[-1]
    ids = _lanes(no_batch.i_id, R).reshape(R, -1)
    weight = _lanes(line_valid, R).reshape(R, -1).to(slots.dtype)
    if ids.shape[1] * n_items <= _ONE_HOT_MAX_ELEMS:
        demand = ((ids[..., None] == torch.arange(n_items, device=dev))
                  * weight[..., None]).sum(dim=1).to(slots.dtype)
        item_slots = slots + demand
    else:
        flat = (ids.long() + n_items * torch.arange(
            R, device=dev)[:, None]).reshape(-1)
        item_slots = slots.clone()
        item_slots.view(-1).index_add_(0, flat, weight.reshape(-1))
    return m._replace(latency=latency,
                      item_access=CounterLattice(item_slots))


def fold_counters(m: ObsMetrics, payments: torch.Tensor,
                  order_statuses: torch.Tensor, stock_levels: torch.Tensor,
                  deliveries: torch.Tensor, aborts: torch.Tensor
                  ) -> ObsMetrics:
    """Fold the run's final MixCounters lanes (each ``[R]``) into the
    lattice, once a run: the counters start at zero, so the finals are
    the run's totals. Payment, Order-Status, Stock-Level and Delivery are
    always home-local, proxy 1 step, bin 0 of each type's histogram; the
    escrow aborts land in the per-replica abort counter."""
    dtype = m.latency.counts.dtype
    counts = m.latency.counts.clone()
    for t, x in ((_PAYMENT, payments), (_ORDER_STATUS, order_statuses),
                 (_STOCK_LEVEL, stock_levels), (_DELIVERY, deliveries)):
        counts[:, t, 0] += x.to(dtype)
    return m._replace(
        latency=m.latency._replace(counts=counts),
        aborts=CounterLattice(m.aborts.slots
                              + aborts.to(m.aborts.slots.dtype)))


def add_cold_rejects(m: ObsMetrics, rej: torch.Tensor) -> ObsMetrics:
    """One drain's per-shard cold rejects (``[R]``) into the counter."""
    return m._replace(cold_rejects=CounterLattice(
        m.cold_rejects.slots + rej.to(m.cold_rejects.slots.dtype)))


def metrics_to_host(m: ObsMetrics) -> ObsMetrics:
    """The lattice on the host, in one device-to-host copy: every leaf's
    32-bit words packed into one buffer on the device, copied once and
    unpacked (the float edges travel as their bits)."""
    leaves = [m.latency.edges, m.latency.counts, m.aborts.slots,
              m.cold_rejects.slots, m.item_access.slots]
    words = [x.contiguous().view(torch.int32).reshape(-1) for x in leaves]
    flat = torch.cat(words).cpu()
    out, at = [], 0
    for x, w in zip(leaves, words):
        out.append(flat[at:at + w.numel()].view(x.dtype).reshape(x.shape))
        at += w.numel()
    edges, counts, aborts, cold, items = out
    return ObsMetrics(HistogramLattice(edges, counts), CounterLattice(aborts),
                      CounterLattice(cold), CounterLattice(items))


# ---------------------------------------------------------------------------
# Host-side snapshot math (numpy on the host copy)
# ---------------------------------------------------------------------------


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def histogram_quantile(edges, counts, q: float) -> float:
    """Conservative quantile from binned counts: the UPPER edge of the bin
    holding the q-th observation (the top bin reports its lower edge, open
    above). 0.0 for an empty histogram."""
    counts = _np(counts)
    edges = _np(edges).astype(np.float64)
    total = counts.sum()
    if total == 0:
        return 0.0
    cum = np.cumsum(counts)
    b = int(np.searchsorted(cum, q * total, side="left"))
    uppers = np.concatenate([edges, edges[-1:]])  # top bin: lower edge
    return float(uppers[min(b, len(uppers) - 1)])


def latency_summary(metrics_host, step_wall_s: float | None = None) -> dict:
    """Per-transaction-type latency-proxy p50/p99 of the merged histogram;
    ``step_wall_s`` (the run's wall seconds a step) adds them in
    seconds."""
    lat = metrics_host.latency
    merged = _np(lat.counts).sum(axis=0)
    out = {}
    for t, name in enumerate(TXN_TYPES):
        row = {"count": int(merged[t].sum()),
               "p50_steps": histogram_quantile(lat.edges, merged[t], 0.50),
               "p99_steps": histogram_quantile(lat.edges, merged[t], 0.99)}
        if step_wall_s is not None:
            row["p50_s"] = row["p50_steps"] * step_wall_s
            row["p99_s"] = row["p99_steps"] * step_wall_s
        out[name] = row
    return out


def heartbeat_lag_histogram(lags, n_bins: int = OBS_BINS) -> HistogramLattice:
    """Detection-latency samples (``LeaseMonitor.detection_lags``, in
    drain windows) as a one-lane HistogramLattice on the host, with the
    latency proxy's bins and join."""
    hist = HistogramLattice.make(1, n_bins, device="cpu")
    lags = torch.from_numpy(np.asarray(lags, np.int64).reshape(-1))
    if lags.numel() == 0:
        return hist
    counts = _bin_counts(hist, lags[None], torch.ones_like(lags)[None])
    return hist._replace(counts=hist.counts + counts.to(hist.counts.dtype))


def heartbeat_lag_summary(hist: HistogramLattice) -> dict:
    """p50/p99 detection latency (in drain windows) of a merged
    heartbeat-lag histogram."""
    merged = _np(hist.counts).sum(axis=0)
    return {"count": int(merged.sum()),
            "p50_windows": histogram_quantile(hist.edges, merged, 0.50),
            "p99_windows": histogram_quantile(hist.edges, merged, 0.99)}


def item_access_summary(metrics_host, top_k: int = 10) -> dict:
    """The live item profile: merged per-item demand, the top-K items and
    their share of the demand."""
    demand = _np(metrics_host.item_access.slots).sum(axis=0)
    total = int(demand.sum())
    order = np.argsort(demand)[::-1][:top_k]
    return {
        "total_line_demand": total,
        "top_items": [{"i_id": int(i), "accesses": int(demand[i])}
                      for i in order if demand[i] > 0],
        "top_k_fraction": float(demand[order].sum() / total) if total else 0.0,
    }
