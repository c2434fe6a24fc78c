"""Interior cells advanced by one RK3 step (both levels on a two-level
grid), summed over every step of the window, over the window's seconds."""


def read(run):
    return run.cell.cells_per_step * run.window.steps / run.window.seconds
