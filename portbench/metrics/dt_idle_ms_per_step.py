"""Device idle ms per step in the device-only traced sub-window while the
host is inside ``repro_torch.courant_dt`` (``portbench/programtrace.py``)."""
from portbench import programtrace


def read(run):
    got = programtrace.of_run(run)
    if got is None:
        return None
    return got["parts"]["dt"] / got["steps"] / 1e6
