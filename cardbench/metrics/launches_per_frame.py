"""Device operations (kernels, copies, sets) a frame, in the traced
stretch."""


def read(ctx):
    rec = ctx.trace_record
    if rec is None or not rec["device"] or not ctx.traced_frames:
        return None
    return len(rec["device"]) / ctx.traced_frames
