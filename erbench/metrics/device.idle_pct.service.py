"""Share of the traced window in which no kernel, copy or set ran on the
card (``torch.profiler``)."""


def read(record):
    tr = record.get("trace")
    if record["kind"] != "service" or tr is None or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
