"""step_host_ms.eval: host ms a batch inside the program's
``lighthand.graph.call`` spans (``StepGraphs.__call__``: copy-in,
graph launch, gradient rebinding, output clones) of a profiled
sub-window."""

from lhbench import program_spans


def read(run):
    return program_spans.host_ms_per_unit(run, "lighthand.graph.call")
