"""The port's Theorem 1 machinery (``repro_torch.core.witness``) and its
replicated systems (``repro_torch.core.systems``) against the JAX
package's, on the CPU: for every system of ``ALL_SYSTEM_FACTORIES``,
``check_confluence_empirically``, ``search_witness`` and
``check_convergence`` give the reference's results for the same seeds
(both draw from numpy's generator), as ``tests/test_theorem1.py``
exercises them.

Tolerance: exact: every result is a count, a flag or a numpy state.
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

from repro.core import systems as jsys  # noqa: E402
from repro.core import witness as jwit  # noqa: E402
from repro_torch.core import systems, witness  # noqa: E402

NAMES = sorted(systems.ALL_SYSTEM_FACTORIES)


def _same_state(x, y, tag):
    assert sorted(x) == sorted(y), tag
    for k in x:
        np.testing.assert_array_equal(x[k], y[k], err_msg=f"{tag}: {k}")


def test_the_same_systems_and_verdicts():
    assert NAMES == sorted(jsys.ALL_SYSTEM_FACTORIES)
    assert systems.EXPECTED_CONFLUENT == jsys.EXPECTED_CONFLUENT
    assert [t.name for t in systems.payroll_transactions()] == \
        [t.name for t in jsys.payroll_transactions()]


@pytest.mark.parametrize("name", NAMES)
def test_confluence_witness_and_convergence_match_reference(name):
    ours = systems.ALL_SYSTEM_FACTORIES[name]()
    ref = jsys.ALL_SYSTEM_FACTORIES[name]()
    assert ours.name == ref.name
    got = witness.check_confluence_empirically(ours, seed=42, trials=400,
                                               max_seq_len=5)
    assert got == jwit.check_confluence_empirically(ref, seed=42, trials=400,
                                                    max_seq_len=5)
    assert (got["violations"] == 0) == systems.EXPECTED_CONFLUENT[name]

    w = witness.search_witness(ours, seed=7, max_trials=3000, max_seq_len=5)
    jw = jwit.search_witness(ref, seed=7, max_trials=3000, max_seq_len=5)
    assert (w is None) == (jw is None)
    assert (w is None) == systems.EXPECTED_CONFLUENT[name]
    if w is not None:
        assert w.describe() == jw.describe()
        for f in ("ancestor", "left_state", "right_state", "merged"):
            _same_state(getattr(w, f), getattr(jw, f), f"{name}.{f}")
        assert ours.check(w.left_state) and ours.check(w.right_state)
        assert not w.merged_valid

    assert witness.check_convergence(ours, seed=3, trials=60) == \
        jwit.check_convergence(ref, seed=3, trials=60)
    assert witness.check_convergence(ours, seed=3, trials=60)
