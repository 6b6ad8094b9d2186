"""Share of the traced window in which the card idles while the executor
thread waits for a planned batch (``batcher.await_plan``): every piece
``erbench.program_trace`` names ``<span> (starved)``."""
from erbench import program_trace


def read(record):
    return program_trace.idle_pct(
        record, lambda name: name.endswith(program_trace.STARVED),
        kind="service")
