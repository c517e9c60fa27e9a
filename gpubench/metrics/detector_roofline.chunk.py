"""The detector's share of its roofline: the least time the chip could
take for its convs at the chunk's K x S frames (``flops.roofline_s``) over
the device time of one forward of the program's detector on the chunk's
letterboxed frames (CUDA events, the median of five calls)."""


def read(ctx):
    if ctx["kind"] != "chunk" or not ctx.get("detector_forward_s"):
        return None
    bound = ctx["flops"].roofline_s(ctx["detector_convs"],
                                    ctx["frames_per_chunk"])
    return {"value": bound / ctx["detector_forward_s"] * 100, "unit": "%"}
