"""Host milliseconds from a K=1 step's call to its return, before the
wait for its rows: the dispatch cost. The median over the steps of the
unprofiled window."""

import statistics


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "k1" or not w.enqueue_s:
        return None
    return {"value": statistics.median(w.enqueue_s) * 1e3, "unit": "ms"}
