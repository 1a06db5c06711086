"""Self-detecting liveness: the heartbeat/lease lattice and the local
lease monitor, the port of ``repro.runtime.liveness`` (pure numpy, as
there).

* **Heartbeats are monotone.** Each replica stamps (epoch, seq)
  high-water marks (``core.lattice.LeaseLattice``, a per-slot MaxReg). The
  stamps ride the anti-entropy drain the fleet already runs every window,
  so liveness knowledge costs no new collective on the hot path, and the
  joins commute, associate and idempote: every member converges to the
  same view whatever the delivery order.
* **Leases are local thresholds.** Declaring a replica dead is the one
  non-monotone step, so it is never negotiated: each observer derives the
  alive mask from its own joined stamps. A replica whose stamp has not
  advanced for ``expiry`` windows is SUSPECT, and only after
  ``hysteresis`` more silent windows is it declared dead, so a straggler
  (one slow chunk, ``runtime.failures.straggler_step_times``) is not
  reclaimed for one hiccup: detection takes at most
  ``expiry + hysteresis + 1`` windows, and a shorter stall is absorbed.
* **False suspicion is safe, not prevented.** A suspected replica that
  beats again is revived (its stamp advances, its staleness resets). Until
  the next share refresh it holds ZERO escrow shares, and the min-join
  share path never manufactures admission capacity, so a premature
  reclamation can waste throughput but never oversell. A replica whose OWN
  lease has expired in its own view stops serving (self-fencing, the lease
  discipline that prevents split-brain once a successor adopts its shard).

``LeaseMonitor`` is the host-side observer the closed-loop driver
(``txn.drivers.run_loop(liveness=...)``) and the pod simulator share: feed
it stamps (``observe``/``beat``, or a ``source`` polled at each ``tick``),
read the derived mask, and collect detection-latency samples.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.lattice import (LeaseLattice, pack_lease_stamp,
                                      unpack_lease_stamp)

__all__ = ["LeaseMonitor", "LeaseLattice", "pack_lease_stamp",
           "unpack_lease_stamp"]


@dataclasses.dataclass
class LeaseMonitor:
    """Derives the fleet's alive mask locally from heartbeat staleness.

    ``expiry`` is the lease length in drain windows (stamp not advanced for
    more than ``expiry`` windows => suspect); ``hysteresis`` is how many
    additional consecutive suspect windows must pass before the replica is
    declared dead. A replica is ALIVE iff its staleness is at most
    ``expiry + hysteresis``; the bound on detection latency (and on the
    stall a straggler may take without being reclaimed) is
    ``detection_bound = expiry + hysteresis + 1`` windows.

    ``source``, if given, is polled once per :meth:`tick` with the current
    window index and must return the fleet's [R] packed stamps (the joined
    heartbeat view arriving with that window's drain).
    """

    n_replicas: int
    expiry: int = 1
    hysteresis: int = 1
    source: Callable[[int], np.ndarray] | None = None

    def __post_init__(self):
        R = self.n_replicas
        self.lease = LeaseLattice.make(R)         # joined high-water marks
        self._prev = np.zeros(R, np.int64)        # stamps at last tick
        self.stale = np.zeros(R, np.int64)        # windows without progress
        self.window = 0
        # (window, replica, staleness-at-declaration) per alive->dead flip
        self.detections: list[tuple[int, int, int]] = []
        self.revivals: list[tuple[int, int]] = []

    @property
    def detection_bound(self) -> int:
        """Max windows from a replica's last beat to its declared-dead."""
        return self.expiry + self.hysteresis + 1

    # -- lattice side (monotone) --------------------------------------------

    def observe(self, stamps) -> None:
        """Join a fleet stamp view ([R] packed int64) into the lease
        lattice — the monotone half; order/duplication cannot matter."""
        self.lease = LeaseLattice.join(
            self.lease, LeaseLattice(np.asarray(stamps, np.int64)))

    def beat(self, replica: int, epoch: int, seq: int) -> None:
        """Record one replica's heartbeat directly (test/driver hook)."""
        self.lease = self.lease.beat(replica, epoch, seq)

    # -- lease side (local threshold) ---------------------------------------

    def alive(self) -> np.ndarray:
        """The derived [R] bool mask — pure function of the lattice view
        plus this observer's window clock, identical at every observer with
        the same joined state."""
        return np.asarray(self.stale <= self.expiry + self.hysteresis)

    def alive_mask(self, dtype=np.int32) -> np.ndarray:
        return self.alive().astype(dtype)

    def tick(self) -> np.ndarray:
        """Advance one drain window: poll ``source`` (if any), compare
        stamps against the previous window, update staleness, and return
        the fresh alive mask. Records detection-latency samples (in
        windows) at every alive -> dead transition."""
        if self.source is not None:
            self.observe(self.source(self.window))
        self.window += 1
        stamps = np.asarray(self.lease.stamps, np.int64)
        advanced = stamps > self._prev
        self._prev = stamps.copy()
        was = self.alive()
        self.stale = np.where(advanced, 0, self.stale + 1)
        now = self.alive()
        for r in np.nonzero(was & ~now)[0]:
            self.detections.append((self.window, int(r),
                                    int(self.stale[r])))
        for r in np.nonzero(now & ~was)[0]:
            self.revivals.append((self.window, int(r)))
        return now

    def detection_lags(self) -> list[int]:
        """Detection-latency samples (windows from last observed beat to
        declared-dead) — the obs plane's heartbeat-lag histogram input."""
        return [lag for (_, _, lag) in self.detections]
