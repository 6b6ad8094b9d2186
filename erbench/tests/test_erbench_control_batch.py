"""The control of the batch cells, at their full size: the reference with
stage 1 in TF32 (emulated on the CPU by rounding the float32 features to
TF32) comes out not correct against each cell's limits."""
import pytest

from erbench.control import control_numbers
from erbench.harness import Layout, make_cell
from erbench.check import verdict


@pytest.mark.parametrize("cell", ["ds1_products.batch_pair_range",
                                  "ds1_products.batch_sorted_neighborhood"])
def test_tf32_control_fails(cell):
    layout = Layout()
    c = make_cell(layout, cell, 3141592653, 0, False, "cpu")
    numbers, limits = control_numbers(c)
    correct, compared = verdict(numbers, limits)
    assert not correct, compared
    assert numbers["survivor_diff"] > limits["survivor_diff"]
