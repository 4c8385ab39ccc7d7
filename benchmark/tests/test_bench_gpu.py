"""On the card, at each cell's own size with a short window: the program is
correct, its control (the bf16 density copy) and each fault the cell can
have are not. Run on the chip: ``python -m pytest benchmark/tests -m gpu``
(about five minutes)."""

import pytest
import torch

from benchmark import faults, harness
from benchmark.tests.test_bench_cells import CELLS, _applies

SEED = 3_300_000_000


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _run(name, seed, card, **kw):
    r = harness.run_cell(harness.Cell(name), seed, 0.5, False, device=card, log=lambda m: None,
                         **kw)
    torch.cuda.empty_cache()
    return r


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_program_correct_control_not(card, name):
    ok = _run(name, SEED, card)
    assert ok["correct"], ok["checks"]
    ctl = _run(name, SEED + 1, card, storage="bf16")
    assert not ctl["correct"], ctl["checks"]


@pytest.mark.gpu
@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_fault_not_correct(card, name, fault):
    if not _applies(name, fault):
        pytest.skip(f"the {fault} fault does not apply to {name}")
    with faults.planted(fault):
        r = _run(name, SEED + 2, card)
    assert not r["correct"], r["checks"]
