"""Text → symbol-id sequences for the PyTorch port.

A plain-Python copy of ``emojivoice_tpu.text`` (symbols, cleaners, numbers,
kana).  The JAX package's ``text/__init__.py`` imports ``intersperse`` from
``emojivoice_tpu.utils.masks``, which imports ``jax.numpy``; the port must
run where JAX is not installed, so it carries its own copy until that import
is moved out of the JAX package.  ``tests/test_torch_text.py`` holds the two
copies to identical ids and cleaned text.
"""

from __future__ import annotations

from typing import Sequence

from emojivoice_tpu_torch.text import cleaners as cleaners
from emojivoice_tpu_torch.text.symbols import N_VOCAB, symbols

# FIRST occurrence wins for the table's duplicated symbols ("'" appears five
# times): the first id (174) is inside the trained n_vocab=178 rows
_symbol_to_id: dict = {}
for _i, _s in enumerate(symbols):
    _symbol_to_id.setdefault(_s, _i)


def text_to_sequence(text: str, cleaner_names: Sequence[str]):
    """Clean text and convert each symbol to its id → (ids, cleaned_text).

    Unknown symbols and ids ≥ n_vocab (no trained embedding row) are skipped.
    """
    clean_text = text
    for name in cleaner_names:
        clean_text = cleaners.get_cleaner(name)(clean_text)
    sequence = [i for ch in clean_text
                if (i := _symbol_to_id.get(ch, N_VOCAB)) < N_VOCAB]
    return sequence, clean_text
