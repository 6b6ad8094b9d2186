"""Mean seconds of Job 1 and the strategy's plan per ``run_er`` call: the
program's ``compiler.plan_job`` spans that ended in the traced window,
over its ``pipeline.run_er`` spans (``erbench.program_trace``)."""
from erbench import program_trace


def read(record):
    return program_trace.mean_s(record, "compiler.plan_job",
                                per="pipeline.run_er", kind="batch")
