"""Pallas kernels for the GPU (Triton route) on the BICOS hot loops.

The reference's CUDA kernel layer (``include/impl/cuda/*.cuh``) maps here:

* ``bicos_kernel_smem`` (bicos.cuh:77-140) -> :mod:`.scan` — the O(W^2)
  Hamming argmin scan as an int8 tensor-core product with the packed first
  and last minima folded into its epilogue.
* ``agree_kernel`` / ``agree_subpixel_kernel`` (agree.cuh:110-259) ->
  :mod:`.nxcorr` — NXCORR of the gathered right series and the subpixel
  sweep, one pass over the stacks per pixel block, summed in the
  reference's order.

The XLA path (``libbicos_jax.search`` / ``libbicos_jax.agree``) computes the
same values on every platform; ``search.resolve_backend`` chooses.
"""
