"""Kernel launches per step as the runner counts them
(``stats["kernel_launches"]`` over the window): each bucket launch, a
graph replay or not."""


def read(run):
    if "launches" not in run.counters:
        return None
    return run.counters["launches"] / run.window.steps
