"""CD-PIM reproduction in PyTorch + CUDA for one NVIDIA H100 (Hopper, sm_90a).

Mirrors ``repro`` (the JAX/Pallas package) module for module:
``repro/<x>/<y>.py`` maps to ``repro_torch/<x>/<y>.py``. Plain tensor code is
PyTorch; every Pallas kernel on the ported path is a hand-written CUDA kernel
under ``repro_torch/kernels/*/csrc``. The package imports neither ``jax`` nor
``repro``: modules it needs from the JAX package are kept as its own copies.
"""
__version__ = "0.1.0"
