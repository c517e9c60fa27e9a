"""Device milliseconds a K=1 step of the kernels launched inside the
harness's ``k1_step`` spans (the call of ``make_batched_step``'s step),
from the profiled slice."""


def read(ctx):
    tr = ctx["trace"]
    n = tr["span_count"].get("k1_step", 0)
    if ctx["kind"] != "k1" or not n or "k1_step" not in tr["span_s"]:
        return None
    return {"value": tr["span_s"]["k1_step"] / n * 1e3, "unit": "ms"}
