"""Device milliseconds a K=1 step of the operations launched inside the
program's ``ydt.embed`` span, from the profiled slice."""

from gpubench.spans import per_step


def read(ctx):
    v = per_step(ctx, "ydt.embed", "device_s")
    return None if v is None else {"value": v * 1000, "unit": "ms"}
