"""Library layer of the port: the centered 2-D FFT on ``torch.fft``
(cuFFT on the card) and the pytree BLAS the NLINV solver uses."""
