"""device_idle_frac: the share of the traced window in which no device op
ran (the frozen interval arithmetic of ``devtrace.py``)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s() / tr.window_s
