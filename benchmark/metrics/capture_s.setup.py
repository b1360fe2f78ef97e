"""capture_s.setup: host seconds of the run's CUDA-graph captures (the
program's ``graph.totals()["capture_s"]``), all made in set-up."""

from lhbench import program_spans


def read(run):
    return program_spans.capture_s(run)
