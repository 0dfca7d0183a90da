"""One short run of each cell on the card, through the harness's entry:
``python -m pytest -q -m gpu bench/tests`` on the machine with the card."""
from __future__ import annotations

import time

import pytest

import run
from benchlib import cells


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  cells.benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    out = run.run(cell, 3000000023, 2.0, False, t_start=time.time())
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["metrics"]["train_tokens_per_s"]["value"] > 0
