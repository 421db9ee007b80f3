"""Copy of centrolign_tpu/io/__init__.py."""

from .fasta import parse_fasta
from .gfa import write_gfa, read_gfa

__all__ = ["parse_fasta", "write_gfa", "read_gfa"]
