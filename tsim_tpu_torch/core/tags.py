"""Tag helpers encoding tsim-specific gate metadata in Stim instruction tags.

Mirrors reference ``tsim/core/tags.py`` semantics: a bare ``T`` tag marks a
T-family gate; ``T:<user>`` preserves a user tag alongside the marker.
"""

T_TAG = "T"
_T_USER_PREFIX = "T:"


def encode_t_tag(user_tag: str = "") -> str:
    return f"{_T_USER_PREFIX}{user_tag}" if user_tag else T_TAG


def is_t_tag(tag: str) -> bool:
    return tag == T_TAG or tag.startswith(_T_USER_PREFIX)


def decode_t_user_tag(tag: str) -> str:
    if tag == T_TAG:
        return ""
    if tag.startswith(_T_USER_PREFIX):
        return tag[len(_T_USER_PREFIX):]
    raise ValueError(f"Tag does not encode a T-family gate: {tag!r}")
