"""What decides ``correct``, driven through each cell's whole driver at a
tiny size on the CPU, against the limits in the cell's file: a sound run
passes; the control (the port's bf16 streaming, the precision below the
configuration's) fails; and so does the run with each fault that the cell
can have planted under its timed path. One chip, so no cell has an
exchange between chips to leave out."""

import pytest

from perfbench.tests.tiny import run_tiny

CELLS = ["msrvtt-qa.train", "msvd-qa.train", "msvd-qa.eval", "msrvtt-qa.serve"]
FAULTS = [("msrvtt-qa.train", "unchanged"), ("msrvtt-qa.train", "half"), ("msvd-qa.train", "unchanged"),
          ("msvd-qa.train", "half"), ("msvd-qa.eval", "answer"), ("msrvtt-qa.serve", "answer")]


def correct(result) -> bool:
    return all(c["ok"] for c in result["checks"]) and result["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = run_tiny(cell)
    assert correct(out), out["checks"]
    assert out["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not(cell):
    out = run_tiny(cell, variant="control", readings_only=True)
    assert not correct(out), out["checks"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not(cell, fault):
    out = run_tiny(cell, faults=(fault,), readings_only=True)
    assert not correct(out), out["checks"]
