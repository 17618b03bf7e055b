"""The piper-phonemize espeak phoneme-id map, vendored.

The reference's Emilia tokens.txt starts with the espeak token block from
``piper_phonemize.get_espeak_map()`` (ref egs/zipvoice/local/
prepare_token_file_emilia.py:72-75); the published ZipVoice checkpoints
depend on these exact ids.  piper-phonemize's DEFAULT espeak phoneme-id
table is a fixed public contract (libpiper phoneme_id_map: pad/bos/eos,
clause punctuation, plain latin letters except ``g``, then the espeak IPA
inventory incl. stress/length marks), reproduced here so the tokens.txt
contract can be generated and validated offline.

``get_espeak_map()`` prefers the real piper table when the package is
importable.
"""

from __future__ import annotations

from typing import Dict

_ESPEAK_TOKENS = (
    "_", "^", "$", " ", "!", "'", "(", ")", ",", "-", ".", ":", ";", "?",
    "a", "b", "c", "d", "e", "f", "h", "i", "j", "k", "l", "m", "n", "o",
    "p", "q", "r", "s", "t", "u", "v", "w", "x", "y", "z",
    "æ",  # æ
    "ç",  # ç
    "ð",  # ð
    "ø",  # ø
    "ħ",  # ħ
    "ŋ",  # ŋ
    "œ",  # œ
    "ǀ",  # ǀ
    "ǁ",  # ǁ
    "ǂ",  # ǂ
    "ǃ",  # ǃ
    "ɐ",  # ɐ
    "ɑ",  # ɑ
    "ɒ",  # ɒ
    "ɓ",  # ɓ
    "ɔ",  # ɔ
    "ɕ",  # ɕ
    "ɖ",  # ɖ
    "ɗ",  # ɗ
    "ɘ",  # ɘ
    "ə",  # ə
    "ɚ",  # ɚ
    "ɛ",  # ɛ
    "ɜ",  # ɜ
    "ɞ",  # ɞ
    "ɟ",  # ɟ
    "ɠ",  # ɠ
    "ɡ",  # ɡ (espeak uses the IPA g, not latin g)
    "ɢ",  # ɢ
    "ɣ",  # ɣ
    "ɤ",  # ɤ
    "ɥ",  # ɥ
    "ɦ",  # ɦ
    "ɧ",  # ɧ
    "ɨ",  # ɨ
    "ɪ",  # ɪ
    "ɫ",  # ɫ
    "ɬ",  # ɬ
    "ɭ",  # ɭ
    "ɮ",  # ɮ
    "ɯ",  # ɯ
    "ɰ",  # ɰ
    "ɱ",  # ɱ
    "ɲ",  # ɲ
    "ɳ",  # ɳ
    "ɴ",  # ɴ
    "ɵ",  # ɵ
    "ɶ",  # ɶ
    "ɸ",  # ɸ
    "ɹ",  # ɹ
    "ɺ",  # ɺ
    "ɻ",  # ɻ
    "ɽ",  # ɽ
    "ɾ",  # ɾ
    "ʀ",  # ʀ
    "ʁ",  # ʁ
    "ʂ",  # ʂ
    "ʃ",  # ʃ
    "ʄ",  # ʄ
    "ʈ",  # ʈ
    "ʉ",  # ʉ
    "ʊ",  # ʊ
    "ʋ",  # ʋ
    "ʌ",  # ʌ
    "ʍ",  # ʍ
    "ʎ",  # ʎ
    "ʏ",  # ʏ
    "ʐ",  # ʐ
    "ʑ",  # ʑ
    "ʒ",  # ʒ
    "ʔ",  # ʔ
    "ʕ",  # ʕ
    "ʘ",  # ʘ
    "ʙ",  # ʙ
    "ʛ",  # ʛ
    "ʜ",  # ʜ
    "ʝ",  # ʝ
    "ʟ",  # ʟ
    "ʡ",  # ʡ
    "ʢ",  # ʢ
    "ʲ",  # ʲ
    "ˈ",  # ˈ primary stress
    "ˌ",  # ˌ secondary stress
    "ː",  # ː length mark
    "ˑ",  # ˑ half-length
    "˞",  # ˞ rhoticity
    "β",  # β
    "θ",  # θ
    "χ",  # χ
    "ᵻ",  # ᵻ
    "ⱱ",  # ⱱ
)

VENDORED_ESPEAK_MAP: Dict[str, int] = {
    tok: i for i, tok in enumerate(_ESPEAK_TOKENS)
}


def get_espeak_map() -> Dict[str, int]:
    """token -> id, preferring the real piper_phonemize table when present."""
    try:
        from piper_phonemize import get_espeak_map as piper_map  # type: ignore

        return {tok: ids[0] for tok, ids in piper_map().items()}
    except ImportError:
        return dict(VENDORED_ESPEAK_MAP)
