"""replay_host_ms.train: host ms a microbatch inside the program's
``lighthand.graph.replay`` spans (the CUDA graph's launch alone) of a
profiled sub-window."""

from lhbench import program_spans


def read(run):
    return program_spans.host_ms_per_unit(run, "lighthand.graph.replay")
