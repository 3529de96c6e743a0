"""step_ms.traced: the decode step's period inside the traced slice, where
the profiler runs (``attn_calls.traced_step_ms``: the device starts of
consecutive steps' first-layer decode attention, in ms). Beside
``step_ms``, which the rest of the window reads untraced, it says how far
the profiler slowed the host while ``device_idle_frac`` was read."""

from benchmark.attn_calls import traced_step_ms


def read(run):
    return traced_step_ms(run)
