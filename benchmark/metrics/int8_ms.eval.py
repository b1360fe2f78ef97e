"""int8_ms.eval: device ms a batch in the port's int8 kernels (the quantized
convs and the grouped weight quantize) of a profiled sub-window."""

from lhbench import readers


def read(run):
    return readers.device_ms_per_unit(run, readers.INT8_KERNELS)
