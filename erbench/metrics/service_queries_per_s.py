"""Queries answered per second: every query of every request sent in the
window, over the time from the window's start to the last answer."""


def read(record):
    if record["kind"] != "service" or record["window_s"] <= 0:
        return None
    return record["queries"] / record["window_s"]
