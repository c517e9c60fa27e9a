"""The ReID net's share of its roofline: the least time the chip could
take for its convs at the chunk's crop batch (its most common bucket x K x
S crops) over the device time of one embed of the program's ReID net on
that batch (CUDA events, the median of five calls)."""


def read(ctx):
    if ctx["kind"] != "chunk" or not ctx.get("reid_embed_s"):
        return None
    bound = ctx["flops"].roofline_s(ctx["reid_convs"], ctx["reid_batch"])
    return {"value": bound / ctx["reid_embed_s"] * 100, "unit": "%"}
