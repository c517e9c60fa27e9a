"""Model operations of the frames the chunk window completed -- the
detector's convs for every frame and the ReID net's for every real
detection (padding rows of a bucket count as loss) -- over the bf16 peak
times the window's seconds (the unprofiled window of the traced run)."""


def read(ctx):
    if ctx["kind"] != "chunk" or not ctx["window"].secs:
        return None
    w, f = ctx["window"], ctx["flops"]
    ops = w.frames * (f.total_ops(ctx["detector_convs"])
                      + ctx["dets_per_frame"] * f.total_ops(ctx["reid_convs"]))
    return {"value": ops / (f.PEAK_OPS_PER_S["bf16"] * w.secs) * 100,
            "unit": "%"}
