"""Device milliseconds a chunk of the kernels launched inside the harness's
``detect`` spans (``BucketedScannedStep.detect``: letterbox, detector,
NMS), from the profiled slice."""


def read(ctx):
    tr = ctx["trace"]
    n = tr["span_count"].get("detect", 0)
    if ctx["kind"] != "chunk" or not n or "detect" not in tr["span_s"]:
        return None
    return {"value": tr["span_s"]["detect"] / n * 1e3, "unit": "ms"}
