"""Set-up seconds: from the run's start (before the imports) to the
timed window: loading, the initial state, the runner and its warmup, and
one untimed step."""


def read(run):
    return run.setup_s
