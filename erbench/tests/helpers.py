"""Small cells on the CPU for the benchmark's tests."""
import time

from erbench.harness import Layout, make_cell, run_cell

SMALL = {"ds1_products": {"data": {"n": 3000}},
         "ds2_publications": {"data": {"n": 6000},
                              "service": {"prefix_len": 3}}}


def small_cell(name, seed=123456789012, seconds=1.0, trace=False,
               layout=None, config=None, traffic=None):
    """``name`` at a size a test can hold, on the CPU."""
    layout = layout or Layout()
    conf = config or SMALL[name.split(".")[0]]
    return make_cell(layout, name, seed, seconds, trace, "cpu",
                     overrides={"config": conf, "traffic": traffic or {},
                                "check": {"check_pairs": 10 ** 6}})


def run_small(name, layout=None, **kw):
    layout = layout or Layout()
    return run_cell(small_cell(name, layout=layout, **kw),
                    time.perf_counter(), layout)
