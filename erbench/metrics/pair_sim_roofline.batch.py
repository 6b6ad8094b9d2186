"""The catalog kernel's share of its roofline over the window: the least
time that stage 1's live pairs need (``erbench.roofline``) over the
device time of every ``catalog_kernel`` launch in the trace."""
from erbench import roofline


def read(record):
    tr = record.get("trace")
    if record["kind"] != "batch" or tr is None or \
            record.get("rows_touched") is None:
        return None
    kernel_s = sum(v for k, v in tr["kernel_s"].items()
                   if "catalog_kernel" in k)
    if kernel_s <= 0:
        return None
    flops, nbytes = roofline.stage1_cost(
        record["live_pairs"], record["rows_touched"], record["survivors"],
        record["feature_dim"])
    least, _ = roofline.least_time(flops, nbytes, record["device_name"])
    return roofline.share_pct(least, kernel_s)
