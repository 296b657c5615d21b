from emojivoice_tpu_torch.apps.emoji import (
    EMOJI_MAPPING,
    EMOJI_MAPPING_MALE,
    is_emoji,
    parse_emoji_response,
    strip_emoji,
)

__all__ = [
    "EMOJI_MAPPING",
    "EMOJI_MAPPING_MALE",
    "is_emoji",
    "strip_emoji",
    "parse_emoji_response",
]
