"""The counterparts of the reference's examples (``examples/quickstart.py``,
``train_lm.py``, ``coord_dp.py``) as ``python -m repro_torch.launch.*``,
on the CPU at tiny sizes: the quickstart prints what the reference prints,
line for line; ``train_lm`` trains, checkpoints and resumes with a falling
loss; ``coord_dp`` keeps every hot step free of collectives, counts the
deferred merge's bytes exactly and converges in every mode.
"""

import contextlib
import io
import os
import runpy

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")   # the reference side

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import tree as T  # noqa: E402
from repro_torch.launch import coord_dp, quickstart, train_lm  # noqa: E402

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def _printed(fn) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue()


def test_quickstart_prints_the_references_output():
    """Table 2's marks, the payroll verdicts, the Theorem 1 dynamics and
    the training plan, line for line as the reference's example prints
    them."""
    want = _printed(lambda: runpy.run_path(
        os.path.join(ROOT, "examples", "quickstart.py"), run_name="__main__"))
    got = _printed(lambda: quickstart.run([]))
    assert got == want
    assert "7 free / 3 escrow / 0 required" in got


def test_train_lm_trains_checkpoints_and_resumes():
    out = train_lm.run(["--device", "cpu", "--steps", "10", "--batch", "4",
                        "--seq", "16"])
    hist = out["summary"]["history"]
    assert out["summary"]["step"] == 10 and len(hist) == 2
    assert hist[-1]["loss_mean"] < hist[0]["loss_mean"]
    assert out["resumed"]["step"] == 20
    assert out["resumed"]["history"][-1]["loss_mean"] < hist[0]["loss_mean"]


def test_coord_dp_hot_path_and_merge_bytes():
    out = coord_dp.run(["--device", "cpu", "--steps", "4"])
    cfg = registry.get_config("smollm-360m").reduced()
    n = registry.exact_param_count(cfg)
    leaves = len(T.leaves(registry.abstract_params(cfg)))
    for (mode, compress), row in out.items():
        assert row["step"].total_ops == 0, mode
        assert row["losses"][-1] < row["losses"][0], (mode, compress)
        merge = row["merge"]
        if mode == "sync":
            assert merge is None
            continue
        # params, mu and nu: a float32 sum of one pod's block a leaf, or an
        # int8 all-gather of both pods and a pmax scalar a leaf
        if compress == "none":
            assert dict(merge.counts) == {"all-reduce": 3 * leaves}
            assert sum(merge.bytes.values()) == 3 * 4 * n
        else:
            assert dict(merge.counts) == {"all-gather": 3 * leaves,
                                          "all-reduce": 3 * leaves}
            assert sum(merge.bytes.values()) == 3 * (2 * n + 4 * leaves)
