"""The control of the service cells on DS1 at full size, over as many
requests as a run answers: stage 1 in TF32 comes out not correct."""
from erbench.check import verdict
from erbench.control import control_numbers
from erbench.harness import Layout, make_cell


def test_tf32_control_fails():
    layout = Layout()
    c = make_cell(layout, "ds1_products.service_closed32", 2718281828, 0,
                  False, "cpu")
    numbers, limits = control_numbers(c, requests=2000)
    correct, compared = verdict(numbers, limits)
    assert not correct, compared
    assert numbers["survivor_diff"] > limits["survivor_diff"]
