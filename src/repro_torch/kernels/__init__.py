"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version: ``coil_mult`` (the NLINV pointwise chains), ``cg_fused`` (the
CG vector updates), ``masked_allreduce`` (the distributed channel sum's
local half), ``gridding`` (radial degrid and its adjoint) and the LM
kernels (``flash_attention``, ``rg_lru``, ``mlstm``).
``registry`` lists them; ``_build`` compiles ``csrc/*.cu`` at first
launch."""
