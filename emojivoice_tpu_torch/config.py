"""Configuration of the port: the JAX package's config dataclasses and presets.

``emojivoice_tpu.config`` is plain dataclasses and imports no JAX (the JAX
package's ``__init__`` imports only it), so both packages build their
modules from one source of model shapes and presets.  The port's modules
import configuration from here, never from the JAX package directly.

Importing this runs ``emojivoice_tpu/__init__.py`` too, so the port (and
``chip_smoke.py``) depends on that ``__init__`` importing nothing but this
config; ``tests/test_torch_import.py`` guards it with JAX blocked.
"""

from emojivoice_tpu.config import *  # noqa: F401,F403
from emojivoice_tpu.config import PRESETS, get_preset  # noqa: F401
