"""Host ms per step spent enqueueing launches on the executors
(``ExecutorPool.total_dispatch_s`` over the window)."""


def read(run):
    if "enqueue_s" not in run.counters:
        return None
    return run.counters["enqueue_s"] / run.window.steps * 1e3
