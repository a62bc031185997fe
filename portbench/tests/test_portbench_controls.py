"""On the card: the program's answers pass the comparison and the
control's fail it, for each cell at a size a test run holds.

The control of ``kmer12.collect`` is the reference with soft-masked
windows left out; that of ``snp.call`` the program with TF32 matrix
products switched on.  ``portbench/controls.py`` takes the same readings
at each cell's own size.  Skips where no CUDA device is present.
"""
import pytest

from portbench import controls

pytestmark = pytest.mark.gpu

SIZES = {
    "kmer12.collect": {"config": {"bases": 2_000_000}},
    "snp.call": {"config": {"reads": 262_144}},
}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def over(rec) -> list:
    return [k for k, v in rec["checks"].items() if v > rec["limits"][k]]


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_program_passes_and_control_fails(card, cell):
    recs = list(controls.readings(cell, [2 ** 31 + 19], [2 ** 31 + 19], 2,
                                  card, SIZES[cell]))
    by_side = {r["side"]: r for r in recs}
    assert over(by_side["program"]) == [], by_side["program"]
    assert over(by_side["control"]) != [], by_side["control"]
