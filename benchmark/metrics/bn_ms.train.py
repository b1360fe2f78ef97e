"""bn_ms.train: device ms a microbatch in the "batch norm" kernel family
(BatchNorm forward, backward and statistics) of a profiled sub-window."""

from lhbench import readers


def read(run):
    return readers.device_ms_per_unit(run, family="batch norm")
