"""The port's commitment-latency model against the JAX package's.

``repro_torch.txn.latency`` is numpy only, a copy of ``repro.txn.latency``
without the TPU-fabric kinds. The same seed must give the same floats: every
field of every ``CommitmentResult`` is compared with ``==`` (tolerance:
exact).
"""

import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference module sits in the JAX package

from repro.txn import latency as jl  # noqa: E402
from repro_torch.txn import latency as tl  # noqa: E402


def _fields(results):
    return [dataclasses.astuple(r) for r in results]


@pytest.mark.parametrize("protocol", ["C-2PC", "D-2PC"])
@pytest.mark.parametrize("n", [2, 5])
def test_simulate_lan_matches_reference(protocol, n):
    for seed in (0, 3):
        want = jl.simulate(protocol, jl.DelayModel("lan"), n, trials=50,
                           seed=seed)
        got = tl.simulate(protocol, tl.DelayModel("lan"), n, trials=50,
                          seed=seed)
        assert dataclasses.astuple(got) == dataclasses.astuple(want)


@pytest.mark.parametrize("protocol", ["C-2PC", "D-2PC"])
def test_simulate_wan_matches_reference(protocol):
    parts = ("VA", "OR", "IR")
    want = jl.simulate(protocol, jl.DelayModel("wan", participants=parts), 3,
                       trials=40, seed=7)
    got = tl.simulate(protocol, tl.DelayModel("wan", participants=parts), 3,
                      trials=40, seed=7)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.network == "wan[VA,OR,IR]"


def test_figure3a_matches_reference():
    want, got = jl.figure3a(trials=20, seed=1), tl.figure3a(trials=20, seed=1)
    assert len(got) == 18
    assert _fields(got) == _fields(want)


def test_figure3b_matches_reference():
    want, got = jl.figure3b(trials=10, seed=2), tl.figure3b(trials=10, seed=2)
    assert len(got) == 14
    assert _fields(got) == _fields(want)
    assert tl.REGIONS == jl.REGIONS
    assert all(tl.wan_delay_ms(a, b) == jl.wan_delay_ms(a, b)
               for a in tl.REGIONS for b in tl.REGIONS)


def test_fabric_kinds_are_left_out():
    """The TPU-fabric delay kinds model no part of the port."""
    assert not hasattr(tl, "tpu_fabric")
    import numpy as np
    for kind in ("ici", "dcn"):
        with pytest.raises(ValueError, match=kind):
            tl.DelayModel(kind).sample(np.random.default_rng(0), 4)
