"""Mean seconds of building the match set per ``run_er`` call: the
program's ``pipeline.collect`` spans (stage 2's hits to ``(min, max)``
tuples, the main job's and the match_⊥ job's) that ended in the traced
window, over its ``pipeline.run_er`` spans (``erbench.program_trace``).
None for a program without the span."""
from erbench import program_trace


def read(record):
    return program_trace.mean_s(record, "pipeline.collect",
                                per="pipeline.run_er", kind="batch")
