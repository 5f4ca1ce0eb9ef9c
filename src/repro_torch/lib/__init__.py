"""Library layer of the port: plans (``plan``, re-exported from
``repro_torch.core``), the plan-cached centered 2-D FFT on ``torch.fft``
(cuFFT on the card), plan-cached radial gridding (``gridding``) and the
pytree BLAS the NLINV solver uses."""
