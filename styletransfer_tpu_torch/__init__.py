"""styletransfer_tpu_torch: the PyTorch / CUDA (H100) port of styletransfer_tpu.

The JAX package ``styletransfer_tpu`` is the reference; this package imports
nothing of it. The port goes slice by slice; this slice is fast_st
inference (the pad-early transform-net forward) on two hand-written Hopper
kernels (``ops/cuda``, sources in ``csrc/``).

Layout:
- ``ops``      layers (plain PyTorch) and the CUDA kernels' wrappers
- ``models``   the image transform net
- ``engines``  fast_st inference drivers
- ``utils``    logging and image IO
- ``clis``     ``python -m styletransfer_tpu_torch fast_st ...``

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; without a GPU they raise.
"""

__version__ = "0.1.0"
