"""step_ms: host wall time inside the generate calls of the window
(``Run.calls_in``), over the loop steps the engine counted for them (its
``loop_counts``: decode steps or verify forwards issued)."""


def read(run):
    calls = run.calls_in()
    steps = sum(c.steps for c in calls)
    if not steps:
        return None
    return sum(c.t1 - c.t0 for c in calls) / steps * 1e3
