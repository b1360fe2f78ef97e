"""adam_host_ms.train: host ms a microbatch inside the profiler's
``Optimizer.step#<class>.step`` ranges (Adam, eager between the graph
replays) of a profiled sub-window."""

from lhbench import readers


def read(run):
    return readers.host_ms_per_unit(run, readers.OPTIMIZER_RANGE)
