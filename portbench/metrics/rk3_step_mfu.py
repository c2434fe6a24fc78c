"""Percent of the card's fp32 peak that the whole step reaches: the hydro
family's counted operations for every sub-grid the traced run's timed
window evaluated, over the window's host-clock seconds, over 67e12.  A
lower bound of the work done, since the elementwise work around the
kernels is not counted; it still bounds a kernel's share when a change
takes a kernel off the path.  Read in traced runs only, from their timed
window (spans on, profiler off)."""
from portbench import yardstick


def read(run):
    if run.trace is None:
        return None
    c = run.cell.config
    ops = yardstick.hydro_rhs_ops(
        run.cell.hydro_evaluations_per_step * run.window.steps,
        c["subgrid"], c["ghost"])
    return (100.0 * ops / run.window.seconds
            / yardstick.PEAKS["fp32_flop_per_s"])
