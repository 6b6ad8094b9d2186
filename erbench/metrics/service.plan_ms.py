"""Mean milliseconds of ``ERService._plan_batch`` per batch: the program's
``service.plan_batch`` spans that ended in the traced window, over their
count (``erbench.program_trace``)."""
from erbench import program_trace


def read(record):
    s = program_trace.mean_s(record, "service.plan_batch", kind="service")
    return None if s is None else 1e3 * s
