"""Mean seconds of lowering per ``run_er`` call: the program's
``compiler.lower`` spans that ended in the traced window (the main job's
and the match_⊥ job's), over its ``pipeline.run_er`` spans
(``erbench.program_trace``)."""
from erbench import program_trace


def read(record):
    return program_trace.mean_s(record, "compiler.lower",
                                per="pipeline.run_er", kind="batch")
