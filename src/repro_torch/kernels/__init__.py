"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``coil_mult`` (the NLINV pointwise chains), ``cg_fused`` (the
CG vector updates) and ``gridding`` (radial degrid and its adjoint).
``registry`` lists them; ``_build`` compiles ``csrc/*.cu`` at first
launch."""
