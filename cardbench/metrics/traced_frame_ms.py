"""A frame's wall ms in the traced stretch, on the host's clock from the
stretch's first hand-over to its last fenced image: beside the window's
time a frame (1000 / ``frames_per_s``) it shows how far the tracer slows
the frames that the other trace readers read."""


def read(ctx):
    rec = ctx.trace_record
    if rec is None or not ctx.traced_frames or "wall_s" not in rec:
        return None
    return rec["wall_s"] * 1e3 / ctx.traced_frames
