"""95th percentile (nearest rank) of submit-to-answer time over every
request of the window, timed by the harness's clients."""
import math


def read(record):
    if record["kind"] != "service" or not record["latencies_ms"]:
        return None
    lat = sorted(record["latencies_ms"])
    return lat[math.ceil(0.95 * len(lat)) - 1]
