"""PyTorch/CUDA port of emojivoice_tpu for NVIDIA Hopper (H100).

The JAX package ``emojivoice_tpu`` is the reference this package is held to;
module names follow it (``models/``, ``vocoder/``, ``ops/``, ``inference/``,
``data/``, ``training/``, ``io/``).  Plain tensor code is PyTorch; each Pallas
TPU kernel on a ported path is a hand-written CUDA kernel in ``csrc/`` (K1,
the HiFi-GAN MRF res-block; K2, monotonic alignment search), built at first
use by ``kernels/``.

The package stands alone: it imports no JAX, flax, optax or orbax and nothing
of ``emojivoice_tpu``.  What it needs of the reference's plain-Python modules
(``config.py``, ``apps/emoji.py``, ``text/``, ``data/``) it keeps as its own
copies, which ``tests/test_torch_*.py`` hold equal to the originals.
"""
