"""Device operations (kernels, copies, fills) launched a K=1 step inside
the program's ``ydt.k1_step`` span, from the profiled slice."""

from gpubench.spans import per_step


def read(ctx):
    v = per_step(ctx, "ydt.k1_step", "ops")
    return None if v is None else {"value": v, "unit": "ops"}
