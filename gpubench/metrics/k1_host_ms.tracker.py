"""Host milliseconds a K=1 step inside the program's ``ydt.tracker`` span
(``tracker_step_fused_batched``: K3 and its framework-side prologue), from
the profiled slice."""

from gpubench.spans import per_step


def read(ctx):
    v = per_step(ctx, "ydt.tracker", "host_s")
    return None if v is None else {"value": v * 1000, "unit": "ms"}
