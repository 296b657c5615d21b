"""Emoji → speaker-voice mapping, shared with the JAX package.

``emojivoice_tpu.apps.emoji`` is plain Python (it imports only ``typing``):
each of the 11 emojis is one speaker id of the 109-speaker checkpoint.
Importing it runs ``emojivoice_tpu/__init__.py`` and
``emojivoice_tpu/apps/__init__.py``, which must stay free of JAX
(``tests/test_torch_import.py`` checks it).
"""

from emojivoice_tpu.apps.emoji import EMOJI_MAPPING  # noqa: F401
