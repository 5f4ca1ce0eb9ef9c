"""The share of the window in which nothing ran on the card, in %:
1 - (a traced frame's busy time on the card / the window's time a
frame).  The busy time is the union of the device operations' intervals
in the traced stretch, which the tracer does not lengthen; the time a
frame is the untraced window's, since the tracer slows the host that
paces the frame (``traced_frame_ms`` shows by how much)."""

from .. import trace as tr


def read(ctx):
    rec = ctx.trace_record
    if rec is None or not rec["device"] or not ctx.traced_frames \
            or not ctx.frames or ctx.window_s <= 0:
        return None
    busy = tr.busy_us(rec) / 1e6 / ctx.traced_frames
    return 100.0 * (1.0 - busy / (ctx.window_s / ctx.frames))
