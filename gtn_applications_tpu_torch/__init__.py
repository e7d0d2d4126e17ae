"""gtn_applications_tpu_torch: the PyTorch/CUDA port of ``gtn_applications_tpu``.

A second package beside the JAX one, which stays as the frozen reference.
The port runs the TDS2d + CTC train-then-evaluate path on an NVIDIA H100:
the encoder is plain PyTorch (cuDNN/cuBLAS convolutions and matmuls), and
the CTC lattice and the emission gather run on CUDA kernels written by
hand for ``sm_90a`` (``ops/csrc/``), each with a plain PyTorch version that
CPU tensors take.  Module and function names mirror the JAX package.
"""

__version__ = "0.1.0"
