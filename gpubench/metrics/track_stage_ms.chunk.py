"""Device milliseconds a chunk of the kernels launched inside the harness's
``track`` spans (``BucketedScannedStep.track``: crops, ReID embed, K
tracker launches), from the profiled slice."""


def read(ctx):
    tr = ctx["trace"]
    n = tr["span_count"].get("track", 0)
    if ctx["kind"] != "chunk" or not n or "track" not in tr["span_s"]:
        return None
    return {"value": tr["span_s"]["track"] / n * 1e3, "unit": "ms"}
