"""Queries per super-batch that ``ERBatcher`` dispatched in the window
(its own ``stats``: queries over super_batches)."""


def read(record):
    if record["kind"] != "service":
        return None
    b = record["batcher"]
    return b["queries"] / b["super_batches"] if b["super_batches"] else None
