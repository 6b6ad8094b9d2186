"""Mean seconds of decoding stage 1's packed survivors per ``run_er``
call: the program's ``stage1.decode`` spans (decoded on the card and
copied to the host, inside ``stage1.score``) that ended in the traced
window, over its ``pipeline.run_er`` spans (``erbench.program_trace``).
None for a program without the span."""
from erbench import program_trace


def read(record):
    return program_trace.mean_s(record, "stage1.decode",
                                per="pipeline.run_er", kind="batch")
