"""One module per kind of configuration (a config file's ``scenario``).

Each module has ``Cell(config, mix, device)``: the sizes the config and
the mix fix, the initial state from a seed, the program under test (built
through the program's entry points only) and the plain reference of the
same step.  A state is what the program's ``rk3_step`` takes; ``levels``
turns it into a tuple of level tensors for the comparison.
"""
