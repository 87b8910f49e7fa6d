"""fluidnet_cxx_tpu_torch — the PyTorch/CUDA port of ``fluidnet_cxx_tpu``.

Same module names, layouts and semantics as the JAX package: scalars
``(b, h, w)``, MAC velocity ``(b, 2, h, w)`` with x first, flags ``(b, h, w)``
int32 with the ``celltype`` values. Plain tensor code is PyTorch; the hot
kernels are hand-written CUDA C++ for Hopper (``csrc/``), built by one
``nvcc`` command and bound with ``ctypes`` (``ops/kernels/_build.py``).

The port never imports ``jax`` or the JAX package.
"""
__version__ = "0.1.0"
