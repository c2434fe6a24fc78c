"""The 95th percentile (nearest rank) of every step's wall time in the
window, each step from one host dt read to the next, in ms."""


def read(run):
    return run.window.p95_s() * 1e3
