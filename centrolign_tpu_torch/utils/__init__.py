"""Copy of centrolign_tpu/utils/__init__.py."""

from .encoding import encode_base, encode_seq, decode_base, decode_seq

__all__ = ["encode_base", "encode_seq", "decode_base", "decode_seq"]
