"""gtn_applications_tpu_torch: the PyTorch/CUDA port of ``gtn_applications_tpu``.

A second package beside the JAX one, which stays as the frozen reference.
The port runs the TDS2d train-then-evaluate path with the CTC, ASG, STC
and Transducer (full n-gram, no transitions, or a loaded backoff n-gram)
criteria on an NVIDIA H100: the encoder is plain PyTorch (cuDNN/cuBLAS
convolutions and matmuls), and the CTC lattice, the emission gather, the
ASG Viterbi backtrace, the dense-adjacency lattice scan of STC, the
Transducer's transition-factored scan, the sparse-arc scan of composed
lattices (one step, ``seg_lse``, and the whole scan) and the whole-scan
Viterbi decode run on CUDA kernels written by hand for ``sm_90a``
(``ops/csrc/``), each with a plain PyTorch version that CPU tensors take.  The Transducer's host compilation calls the native graph
compiler (``native/``, built at first use with ``make -C native``).  Training and
evaluation run over ``torch.distributed``, one process per device
(``parallel/``), with a multi-process dry run (``dryrun.py``) and two
examples (``examples/``).  Module and function names mirror the JAX
package.
"""

__version__ = "0.1.0"
