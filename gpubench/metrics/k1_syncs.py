"""Host syncs a K=1 step inside the program's ``ydt.k1_step`` span: runtime
calls that block the host on the device (``spans.SYNCS``), from the
profiled slice."""

from gpubench.spans import per_step


def read(ctx):
    v = per_step(ctx, "ydt.k1_step", "syncs")
    return None if v is None else {"value": v, "unit": "syncs"}
