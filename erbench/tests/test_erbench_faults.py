"""A run with the timed path broken underneath comes out not correct:
half of the stage-1 survivors left out, and an answer altered where it is
produced. (One card, no training: no exchange between chips and no state
to leave unchanged.)"""
import numpy as np
import pytest

from erbench.tests.helpers import run_small
from repro_torch.er import pipeline, service

CELLS = ["ds1_products.batch_pair_range",
         "ds1_products.batch_sorted_neighborhood",
         "ds1_products.service_closed32", "ds2_publications.service_closed32"]


def _break(monkeypatch, fault):
    if fault == "half_of_stage1_left_out":
        execute = pipeline.execute

        def half(*a, **k):
            ca, cb = execute(*a, **k)
            return ca[::2], cb[::2]
        monkeypatch.setattr(pipeline, "execute", half)
        monkeypatch.setattr(service, "execute", half)
    else:
        verify = pipeline.verify_pairs

        def altered(*a, **k):
            ha, hb = verify(*a, **k)
            if ha.size:
                ha = ha.copy()
                ha[0] += 1
            return ha, hb
        monkeypatch.setattr(pipeline, "verify_pairs", altered)
        monkeypatch.setattr(service, "verify_pairs", altered)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["half_of_stage1_left_out",
                                   "answer_altered"])
def test_broken_path_is_not_correct(monkeypatch, cell, fault):
    _break(monkeypatch, fault)
    out = run_small(cell, seconds=0.3)
    assert not out["correct"]
    bad = {k for k, v in out["check"].items() if v["value"] > v["limit"]}
    assert bad & {"survivor_diff", "match_diff"}


def test_unanswered_requests_fail(monkeypatch):
    def boom(self, *a, **k):
        raise RuntimeError("lost")
    monkeypatch.setattr(service.ERService, "_execute_batch", boom)
    # warm-up and the batcher's first request go through match(); break
    # only the window's requests
    from erbench.drivers import closed_loop
    setup = closed_loop.setup

    def setup_then_break(cell):
        monkeypatch.undo()
        state = setup(cell)
        monkeypatch.setattr(service.ERService, "_execute_batch", boom)
        return state
    monkeypatch.setattr(closed_loop, "setup", setup_then_break)
    out = run_small("ds1_products.service_closed32", seconds=0.3)
    assert not out["correct"] and out["failed"] == out["attempted"] > 0
    assert np.isfinite(out["check"]["failed"]["value"])
