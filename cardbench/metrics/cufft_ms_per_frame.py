"""Device ms a frame of cuFFT's kernels, in the traced stretch."""


def read(ctx):
    if ctx.trace_record is None or not ctx.traced_frames:
        return None
    us = [d for name, _, d in ctx.trace_record["device"]
          if "fft" in name.lower()]
    if not us:
        return None
    return sum(us) / 1e3 / ctx.traced_frames
