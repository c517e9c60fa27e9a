"""Host milliseconds a K=1 step inside the program's ``ydt.embed`` span (the
ReID embed route ``_make_embed`` returns), from the profiled slice."""

from gpubench.spans import per_step


def read(ctx):
    v = per_step(ctx, "ydt.embed", "host_s")
    return None if v is None else {"value": v * 1000, "unit": "ms"}
