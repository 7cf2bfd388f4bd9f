"""ytpu_torch: the PyTorch/CUDA port of ytpu's batched CRDT replay.

The package mirrors the layout of `ytpu` (``core``, ``encoding``,
``models``, ``ops``) and imports neither JAX nor the JAX package. Entry
points run on the GPU unless the caller passes ``device="cpu"``; the CUDA
kernels under ``csrc/`` build with ``nvcc`` at first use.
"""

__version__ = "0.1.0"
