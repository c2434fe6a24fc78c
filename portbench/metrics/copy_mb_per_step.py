"""MB per step that the program's spans count as copied
(``copy_bytes``: the copies into the aggregation executor's static
parents, the bucket graphs' copies in and out, the two-level exchange
graph's), over the ``repro_torch.rk3_step`` span trees of the device-only
traced sub-window (``portbench/programtrace.py``), over 1e6."""
from portbench import programtrace


def read(run):
    got = programtrace.of_run(run)
    if got is None:
        return None
    return got["copy_bytes"] / got["steps"] / 1e6
