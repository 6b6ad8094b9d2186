"""Mean milliseconds per batch inside ``ERService`` (its own ``stats``:
seconds over batches, plan through demap, on the host clock)."""


def read(record):
    if record["kind"] != "service":
        return None
    s = record["service"]
    return 1e3 * s["seconds"] / s["batches"] if s["batches"] else None
