"""On the card: a run of every cell at the tiny size through the CUDA
graphs, correct, with its end-to-end and traced metrics. Skips where
there is no card."""

import json

import pytest

from portbench import run
from portbench.tests.tiny import CELLS, tiny


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(workload, trace, capsys):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc = run.main(["--workload", workload, "--seed", "77", "--seconds",
                   "0.2", "--trace", str(trace)], overrides=tiny)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    want = {m["name"] for m in run.metrics_of(run.json.loads(
        (run.ROOT / "BENCHMARK.json").read_text()), workload, bool(trace))}
    if not trace:
        assert set(line["metrics"]) == want
