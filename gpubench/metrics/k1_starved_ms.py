"""Idle device milliseconds a K=1 step whose gap began while the host was
inside the program's ``ydt.k1_step`` span: the device starved by the
step's own enqueue, not waiting on the harness's read-out. From the
profiled slice."""

from gpubench.spans import starved_per_step


def read(ctx):
    v = starved_per_step(ctx)
    return None if v is None else {"value": v * 1e3, "unit": "ms"}
