"""casapose_tpu_torch: the PyTorch/CUDA port of casapose_tpu.

The JAX package ``casapose_tpu`` is the reference; this package imports
neither it nor JAX. Public functions keep the JAX package's NHWC layout.
"""
