"""Atomic-commitment latency model — the paper's Fig. 3 methodology, numpy
only: the port's own copy of ``repro.txn.latency``.

The paper runs Monte-Carlo simulations of two atomic-commitment protocols
over measured one-way network delays:

  * C-2PC — coordinator-based two-phase commit: "a coordinator, two delays of
    N messages each": two sequential rounds, each the slowest of N
    request/response pairs;
  * D-2PC — decentralized 2PC: "one delay of N^2 messages": every server
    broadcasts its vote to all others; commit is visible after the slowest
    of the N*(N-1) pairs.

Throughput upper bound per contended item = 1 / E[commit latency], assuming
perfect pipelining, exactly as in §6.1.

Delay sources:
  * LAN — the Bobtail-style distribution the paper cites (sub-ms body, a
    ~1% multi-ms straggler tail);
  * WAN — fixed one-way delay matrix between the eight EC2 regions of the
    paper (Fig. 3b), derived from published inter-region RTTs.

The same seed gives the same floats as the reference: the draws are the
reference's, in its order.
"""

from __future__ import annotations

import dataclasses

import numpy as np

REGIONS = ("VA", "OR", "CA", "IR", "SP", "TO", "SI", "SY")

# Approximate one-way delays in ms between EC2 regions (upper triangle,
# symmetric), consistent with the HAT paper's measured RTT/2 values.
_WAN_ONE_WAY_MS = {
    ("VA", "OR"): 41.0, ("VA", "CA"): 36.0, ("VA", "IR"): 40.0,
    ("VA", "SP"): 70.0, ("VA", "TO"): 82.0, ("VA", "SI"): 115.0,
    ("VA", "SY"): 115.0,
    ("OR", "CA"): 11.0, ("OR", "IR"): 70.0, ("OR", "SP"): 91.0,
    ("OR", "TO"): 55.0, ("OR", "SI"): 90.0, ("OR", "SY"): 81.0,
    ("CA", "IR"): 76.0, ("CA", "SP"): 96.0, ("CA", "TO"): 58.0,
    ("CA", "SI"): 88.0, ("CA", "SY"): 79.0,
    ("IR", "SP"): 96.0, ("IR", "TO"): 112.0,
    ("IR", "SI"): 87.0, ("IR", "SY"): 163.0,
    ("SP", "TO"): 130.0, ("SP", "SI"): 186.0, ("SP", "SY"): 161.0,
    ("TO", "SI"): 38.0, ("TO", "SY"): 52.0,
    ("SI", "SY"): 92.0,
}


def wan_delay_ms(a: str, b: str) -> float:
    if a == b:
        return 0.15
    return _WAN_ONE_WAY_MS.get((a, b)) or _WAN_ONE_WAY_MS[(b, a)]


@dataclasses.dataclass(frozen=True)
class DelayModel:
    """One-way message delay sampler."""

    kind: str                    # "lan" | "wan"
    participants: tuple[str, ...] = ()   # for WAN: region names

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "lan":
            # Bobtail-style: sub-ms body with a ~1% multi-ms straggler tail
            body = rng.lognormal(np.log(0.25), 0.5, n)
            tail = rng.uniform(3.0, 15.0, n)
            is_tail = rng.random(n) < 0.01
            return np.where(is_tail, tail, body)
        raise ValueError(self.kind)


_WAN_JITTER = 0.05


def _pairwise_wan(rng: np.random.Generator):
    """One-way delays; WAN delays are deterministic RTT/2 + small jitter."""
    def d(a, b):
        base = wan_delay_ms(a, b)
        return base * (1.0 + _WAN_JITTER * rng.standard_normal())
    return d


def c2pc_latency_ms(model: DelayModel, n: int, rng: np.random.Generator
                    ) -> float:
    """Coordinator 2PC: two delays of N messages each (paper §6.1).

    Each "delay" is accounted as a full request/response round trip, which
    reproduces the paper's own figures (D-2PC over VA<->OR at ~83 ms a
    commit is the measured RTT; C-2PC at 2 RTTs gives ~6/s, the F1
    comparison's 6-20 tps). Over the WAN the first participant
    coordinates.
    """
    if model.kind == "wan":
        d = _pairwise_wan(rng)
        coord = model.participants[0]
        others = [p for p in model.participants if p != coord] or [coord]
        # each round: prepare/commit fan-out + ack fan-in = one RTT to slowest
        r1 = max(d(coord, p) + d(p, coord) for p in others)
        r2 = max(d(coord, p) + d(p, coord) for p in others)
        return r1 + r2
    # stochastic kinds: each round = slowest of N request+response pairs
    r1 = (model.sample(rng, n) + model.sample(rng, n)).max()
    r2 = (model.sample(rng, n) + model.sample(rng, n)).max()
    return float(r1 + r2)


def d2pc_latency_ms(model: DelayModel, n: int, rng: np.random.Generator
                    ) -> float:
    """Decentralized 2PC: one delay of N^2 messages (all-to-all votes),
    one round trip over the slowest participant pair."""
    if model.kind == "wan":
        d = _pairwise_wan(rng)
        return max(d(a, b) + d(b, a) for a in model.participants
                   for b in model.participants if a != b)
    pairs = n * max(n - 1, 1)
    return float((model.sample(rng, pairs) + model.sample(rng, pairs)).max())


@dataclasses.dataclass
class CommitmentResult:
    protocol: str
    network: str
    n_servers: int
    mean_latency_ms: float
    p95_latency_ms: float
    max_throughput_per_item: float  # 1 / mean latency


def simulate(protocol: str, model: DelayModel, n_servers: int,
             trials: int = 2000, seed: int = 0) -> CommitmentResult:
    rng = np.random.default_rng(seed)
    fn = c2pc_latency_ms if protocol == "C-2PC" else d2pc_latency_ms
    lat = np.array([fn(model, n_servers, rng) for _ in range(trials)])
    mean = float(lat.mean())
    return CommitmentResult(
        protocol=protocol,
        network=model.kind if model.kind != "wan" else
        f"wan[{','.join(model.participants)}]",
        n_servers=n_servers,
        mean_latency_ms=mean,
        p95_latency_ms=float(np.percentile(lat, 95)),
        max_throughput_per_item=1000.0 / mean,
    )


def figure3a(trials: int = 2000, seed: int = 0) -> list[CommitmentResult]:
    """LAN sweep over the number of participating servers (Fig. 3a)."""
    model = DelayModel("lan")
    out = []
    for n in (2, 3, 4, 5, 6, 7, 8, 9, 10):
        out.append(simulate("C-2PC", model, n, trials, seed))
        out.append(simulate("D-2PC", model, n, trials, seed + 1))
    return out


def figure3b(trials: int = 500, seed: int = 0) -> list[CommitmentResult]:
    """WAN sweep over participating regions, anchored at VA (Fig. 3b)."""
    out = []
    for k in range(2, len(REGIONS) + 1):
        parts = REGIONS[:k]
        model = DelayModel("wan", participants=parts)
        out.append(simulate("C-2PC", model, k, trials, seed))
        out.append(simulate("D-2PC", model, k, trials, seed + 1))
    return out
