"""The whole frame's share of the card's peak, in %: the summed bound of
the work the window's frames needed (``_work.frame_work``, from the
configuration's shapes and each frame's CG iterations) over the window's
time and its chips."""

from ._work import frames_bound_s


def read(ctx):
    if not ctx.cg_frames or ctx.window_s <= 0:
        return None
    cfg = ctx.config
    bound = frames_bound_s(cfg["grid"], cfg["ncoils"], ctx.cg_frames)
    return 100.0 * bound / (ctx.window_s * ctx.chips)
