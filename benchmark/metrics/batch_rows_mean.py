"""batch_rows_mean: prompt rows per generate call (padding rows left out),
over the calls of the window (``Run.calls_in``)."""


def read(run):
    calls = run.calls_in()
    if not calls:
        return None
    return sum(len(c.rows) for c in calls) / len(calls)
