"""The roofline count on a hand-worked catalog, and the trace reduction
that supplies the kernel time."""
import pytest

from erbench import roofline
from erbench.trace import reduce_trace


def test_hand_worked_catalog():
    # 3 blocks of 40, 30 and 1 entities: 780 + 435 live pairs, the 70
    # rows of the two blocks read once, 25 survivors written once.
    flops, nbytes = roofline.stage1_cost(780 + 435, 70, 25, 256)
    assert flops == 2 * 256 * 1215
    assert nbytes == 4 * 256 * 70 + 8 * 25
    least, binds = roofline.least_time(flops, nbytes, "NVIDIA H100 80GB HBM3")
    assert binds == "bytes"
    assert least == pytest.approx(71_880 / 3.35e12)
    assert roofline.share_pct(least, 4 * least) == pytest.approx(25.0)
    assert roofline.share_pct(least, 0.0) is None


def test_operations_bind_on_dense_work():
    flops, nbytes = roofline.stage1_cost(10 ** 9, 1000, 0, 256)
    least, binds = roofline.least_time(flops, nbytes, "NVIDIA H100 PCIe")
    assert binds == "operations" and least == pytest.approx(flops / 67e12)


def test_unknown_card_has_no_peak():
    with pytest.raises(KeyError):
        roofline.peak("cpu")


def test_trace_busy_union_and_gaps():
    us = 1000
    device = [(10 * us, 30 * us, "catalog_kernel<float>"),
              (20 * us, 40 * us, "copy"), (600 * us, 700 * us,
                                           "catalog_kernel<float>")]
    host = [(0, 1000 * us, "service.plan_batch"),
            (300 * us, 500 * us, "compiler.lower")]
    out = reduce_trace(device, host, 0, 1000 * us)
    assert out["busy_s"] == pytest.approx(130e-6)
    assert out["kernel_s"]["catalog_kernel<float>"] == pytest.approx(120e-6)
    gaps = dict(out["breakdown"]["idle_gaps"])
    assert gaps["gaps under 100 us"] == pytest.approx(10e-6)
    assert gaps["compiler.lower"] == pytest.approx(200e-6)
    assert gaps["service.plan_batch"] == pytest.approx(660e-6)
