"""idle_share.eval: % of a profiled sub-window of eval batches in which no
operation ran on the device (union of the trace's device operations over
the CUDA-event window)."""

from lhbench import readers


def read(run):
    return readers.idle_share(run)
