"""Entities resolved per second: the corpus's entities, summed over the
``run_er`` calls of the window (whole runs only), over its wall time."""


def read(record):
    if record["kind"] != "batch" or record["window_s"] <= 0:
        return None
    return record["entities"] / record["window_s"]
