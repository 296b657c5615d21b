"""Symbol vocabulary.

This table is *data*, not code: it must match the reference byte-for-byte
(reference: Matcha-TTS/matcha/text/symbols.py:5-17, itself from
keithito/tacotron) or embedding ids in released checkpoints would be
scrambled.

Fork quirk (reproduced deliberately): the fork extended the IPA set so the
table has 198 entries (including "'" five times), while the model config
still declares ``n_vocab: 178`` (configs/model/matcha.yaml:9).  Ids ≥ 178
would overflow the embedding — the reference's later-duplicate-wins dict
maps "'" to 182 and would index past its own embedding on any raw
apostrophe (it survives only because espeak IPA output never contains
one).  Here lookups keep FIRST-occurrence ids (apostrophe → 174, a trained
id) and ``text_to_sequence`` drops ids ≥ N_VOCAB, the same silent-skip
semantics as unknown characters.
"""

_pad = "_"
_punctuation = ';:,.!?¡¿—…"«»“” '
_letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_letters_ipa = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ'̃'-'̞ᵝʨʦũĩʣʥ%+]\\()["
)

symbols = [_pad] + list(_punctuation) + list(_letters) + list(_letters_ipa)

PAD_ID = 0
SPACE_ID = symbols.index(" ")
# embedding rows in released checkpoints (configs/model/matcha.yaml:9);
# ids ≥ N_VOCAB exist in the table but have no trained embedding
N_VOCAB = 178
