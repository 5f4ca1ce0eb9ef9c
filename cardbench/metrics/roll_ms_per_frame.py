"""Device ms a frame of the kernels ``aten::roll`` launches
(``roll_cuda_kernel``: the ``fftshift``/``ifftshift`` of the centered
FFTs), in the traced stretch."""


def read(ctx):
    if ctx.trace_record is None or not ctx.traced_frames:
        return None
    us = [d for name, _, d in ctx.trace_record["device"]
          if "roll_cuda_kernel" in name]
    if not us:
        return None
    return sum(us) / 1e3 / ctx.traced_frames
