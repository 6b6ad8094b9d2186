"""Mean milliseconds a request waits in ``ERBatcher`` before the planner
takes it into a super-batch: the program's ``batcher.queue`` spans that
ended in the traced window, over their count (``erbench.program_trace``)."""
from erbench import program_trace


def read(record):
    s = program_trace.mean_s(record, "batcher.queue", kind="service")
    return None if s is None else 1e3 * s
