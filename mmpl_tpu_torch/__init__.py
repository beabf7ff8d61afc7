"""mmpl_tpu_torch: the PyTorch/CUDA port of mmpl_tpu for one NVIDIA H100.

The JAX package `mmpl_tpu` stays the reference; this package mirrors its
layout (core/, ops/, schedulers/, models/, pipelines/, utils/, cli.py) and
never imports it.  Hand-written Hopper kernels live in `csrc/` and are
built with nvcc at first use (`ops/_build.py`).
"""

__version__ = "0.1.0"
