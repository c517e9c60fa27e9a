"""Host milliseconds a K=1 step inside the program's ``ydt.detector`` span
(``Darknet.forward``: the backbone's and heads' launches and the YOLO
decode), from the profiled slice."""

from gpubench.spans import per_step


def read(ctx):
    v = per_step(ctx, "ydt.detector", "host_s")
    return None if v is None else {"value": v * 1000, "unit": "ms"}
