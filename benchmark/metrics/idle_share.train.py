"""idle_share.train: % of a profiled sub-window of dispatches in which no
operation ran on the device (union of the trace's device operations over
the CUDA-event window)."""

from lhbench import readers


def read(run):
    return readers.idle_share(run)
