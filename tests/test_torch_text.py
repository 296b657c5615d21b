"""The port's copied text frontend gives the JAX package's ids and cleaned
text, exactly, for every cleaner on the synthesis path (the grapheme
fallback where no phonemizer is installed)."""

import pytest

from emojivoice_tpu import text as jax_text
from emojivoice_tpu.utils.masks import intersperse as jax_intersperse
from emojivoice_tpu_torch import text as port_text
from emojivoice_tpu_torch.utils.masks import intersperse

CORPUS = {
    "english_cleaners2": [
        "The quick brown fox jumped over the lazy dog.",
        "Dr. Smith paid $12.50 for 3 apples on the 21st of May, 1985!",
        "Wait... what?! \"Quotes\", (brackets) and -- dashes; colons: ok",
        "Mr. and Mrs. O'Neil live at 221 Baker St. in 2024.",
    ],
    "basic_cleaners": ["  Hello   THERE, General Kenobi!  ", "numbers 42 stay 4.2"],
    "french_cleaners": ["Il a payé 12.50€ à M. Dupont, à 3 heures.", "Ça coûte 1,5 euros."],
    "german_cleaners": ["Dr. Müller trinkt 2 Bier um 8 Uhr, z.B. heute.", "Straße und Größe!"],
    "spanish_cleaners": ["¿Dónde está el niño? Tiene 7 años.", "¡Mañana será 25 de diciembre!"],
    "japanese_cleaners": ["こんにちは、せかい。3 ねん", "カタカナ と ひらがな 100%"],
}


@pytest.mark.parametrize("cleaner,text", [(c, t) for c, texts in CORPUS.items() for t in texts])
def test_text_to_sequence_matches_jax(cleaner, text):
    ids, cleaned = port_text.text_to_sequence(text, [cleaner])
    ref_ids, ref_cleaned = jax_text.text_to_sequence(text, [cleaner])
    assert cleaned == ref_cleaned
    assert ids == ref_ids
    assert intersperse(ids, 0) == jax_intersperse(ref_ids, 0)


def test_apostrophe_takes_first_symbol_id():
    ids, _ = port_text.text_to_sequence("it's", ["basic_cleaners"])
    assert ids == jax_text.text_to_sequence("it's", ["basic_cleaners"])[0]
    assert max(ids) < 178
