"""The control on the card: the system with TF32 products, the precision
below the float32 with TF32 off that every configuration states, must read
not correct, at a size a test run holds: the models at their widths, the
small grammar and mixes of the CPU tests, one short window each.
The cell-size control readings are in PERF.md."""

import pytest

from conftest import tiny_cell

from benchmark.harness import main


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["tdnnf-batch32", "tdnnf-stream-rt"])
def test_tf32_control_fails_on_the_card(cuda, card_bench, name):
    cell = tiny_cell(card_bench, name)
    assert main.run(cell, 3, 2.0, False, "cuda")["correct"] is True
    res = main.run(cell, 3, 2.0, False, "cuda", control="tf32")
    assert res["correct"] is False, res["checks"]
