"""centrolign_tpu_torch: the PyTorch and CUDA port of centrolign_tpu.

It runs the pairwise path (FASTA -> match finding -> chaining ->
partitioning -> stitching -> CIGAR) and the progressive MSA path (guide
tree -> GFA) of the JAX package, with the chain-gap Gotoh fill and
traceback (csrc/gotoh.cu) and the DAG x DAG PO-POA fill and traceback
(csrc/popoa_dag.cu) as CUDA kernels written for Hopper. The host modules
are the port's own copies of the JAX package's, under the same relative
paths; nothing here imports the JAX package or jax.
"""

__version__ = "0.1.0"

from .graph import BaseGraph
from .alignment import GAP, cigar, explicit_cigar

__all__ = ["BaseGraph", "GAP", "cigar", "explicit_cigar", "__version__"]
