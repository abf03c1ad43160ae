"""PyTorch + CUDA port of ``fv3net_tpu`` for one NVIDIA H100.

``fv3net_tpu`` (JAX) stays the reference: every module here mirrors the
module of the same path there and is held against it by a
``tests/test_torch_*.py`` test on shared numpy inputs.  The package
imports torch and numpy only, never jax and never ``fv3net_tpu``.

The first slice is the gray-radiation flagship chunk
(:func:`fv3net_torch.entry.flagship`); its vertical-remap application runs
as the hand-written CUDA kernel ``csrc/remap_apply.cu`` on CUDA tensors.
"""
