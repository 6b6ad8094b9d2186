"""Set-up time: from the start of the process to the start of the window
(imports, CUDA start, the corpus, ingest, builds or loads, warm-up)."""


def read(record):
    return record["setup_s"]
