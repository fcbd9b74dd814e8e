"""dcc_tpu_torch: the PyTorch / CUDA port of dcc_tpu for NVIDIA Hopper.

A second package beside the JAX reference ``dcc_tpu``: the batched coverage
environment, shared-parameter feed-forward MAPPO and its runtime in
PyTorch, with the JAX package's Pallas kernels rewritten by hand in CUDA
C++ for ``sm_90a`` (``csrc/``). It imports neither JAX nor ``dcc_tpu``.
"""

__version__ = "0.1.0"
