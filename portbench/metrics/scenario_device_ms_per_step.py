"""Device ms per step outside the hydro family's kernels: the union of
busy intervals less the time some hydro kernel runs (extraction, the
two-level exchange, the copies of the graphs, assembly, the combine and
the Courant dt)."""
from portbench.devtrace import family_names


def read(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0:
        return None
    hydro = tr.family_union_s(family_names("hydro_rhs"))
    return (tr.busy_s - hydro) / tr.steps * 1e3
