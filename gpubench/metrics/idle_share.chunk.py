"""The share of the profiled slice of chunks in which no operation ran on
the device: 1 - union of the device operations' intervals / the slice's
wall time."""


def read(ctx):
    tr = ctx["trace"]
    if ctx["kind"] != "chunk" or not tr.get("window_s"):
        return None
    return {"value": (1 - tr["busy_s"] / tr["window_s"]) * 100, "unit": "%"}
