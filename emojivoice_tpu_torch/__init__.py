"""PyTorch/CUDA port of emojivoice_tpu for NVIDIA Hopper (H100).

The JAX package ``emojivoice_tpu`` is the reference this package is held to;
module names follow it (``models/``, ``vocoder/``, ``ops/``, ``inference/``).
Plain tensor code is PyTorch; each Pallas TPU kernel on a ported path is a
hand-written CUDA kernel in ``csrc/``, built at first use by ``kernels/``.
Nothing here imports JAX, flax or orbax.

One dependency on the reference remains: ``config.py`` and ``apps/emoji.py``
re-export ``emojivoice_tpu.config`` and ``emojivoice_tpu.apps.emoji``, so
importing the port runs ``emojivoice_tpu/__init__.py``.  That works only
while the reference's ``__init__`` and those two modules stay free of JAX;
``tests/test_torch_import.py`` checks it with JAX blocked.
"""
