"""Share of the traced window in which the card idles while the executor
thread's innermost span is a ``stage2.*`` span (stage 2's verifier on the
host between its launches), by ``erbench.program_trace``'s rule."""
from erbench import program_trace


def read(record):
    return program_trace.idle_pct(
        record, lambda name: name.startswith("stage2."), kind="service")
