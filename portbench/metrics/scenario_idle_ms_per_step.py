"""Device idle ms per step in the device-only traced sub-window while the
host's innermost program span is a ``repro_torch.scenario.*`` one:
extraction, the two-level exchange, assembly
(``portbench/programtrace.py``)."""
from portbench import programtrace


def read(run):
    got = programtrace.of_run(run)
    if got is None:
        return None
    return got["parts"]["scenario"] / got["steps"] / 1e6
