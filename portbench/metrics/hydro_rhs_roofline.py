"""Percent of the hydro kernels' device time that the roofline bound
needs: the larger of the family's counted fp32 operations over the fp32
peak and its counted bytes over the HBM bandwidth, for every sub-grid the
traced sub-window evaluated, over the union of the family's kernel
intervals."""
from portbench import yardstick
from portbench.devtrace import family_names


def read(run):
    tr = run.trace
    if tr is None:
        return None
    busy = tr.family_union_s(family_names("hydro_rhs"))
    if busy <= 0:
        return None
    n = run.cell.hydro_evaluations_per_step * tr.steps
    c = run.cell.config
    bound = yardstick.roofline_s(
        yardstick.hydro_rhs_ops(n, c["subgrid"], c["ghost"]),
        yardstick.hydro_rhs_bytes(n, c["subgrid"], c["ghost"],
                                  c["n_fields"]))
    return 100.0 * bound / busy
