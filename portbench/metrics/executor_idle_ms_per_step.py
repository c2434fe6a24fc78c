"""Device idle ms per step in the device-only traced sub-window while the
host's innermost program span is a ``repro_torch.agg.*`` or
``repro_torch.graphs.*`` one: submission, staging, the bucket graphs'
replays, the flush and the gather (``portbench/programtrace.py``)."""
from portbench import programtrace


def read(run):
    got = programtrace.of_run(run)
    if got is None:
        return None
    return got["parts"]["executor"] / got["steps"] / 1e6
