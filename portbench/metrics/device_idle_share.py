"""Percent of the device-only traced sub-window in which no operation ran
on the device: 1 - (union of busy intervals over all streams) / window."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
