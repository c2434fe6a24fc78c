"""The plain reference the benchmark holds the program to.

Plain PyTorch only: it imports neither JAX nor either package under
``src/`` (the CPU tests check both).  ``euler``, ``ppm`` and ``flux`` are a
frozen copy of the plain hydro formulas; ``grid`` is the decomposition and
the two-level ghost exchange; ``step`` the Courant dt and the TVD-RK3 step
of the uniform and the two-level grid, evaluated in blocks of sub-grids so
that a whole-grid step fits beside nothing else on one card.
"""
