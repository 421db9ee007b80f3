"""Multi-device and multi-process parallelism of the port.

Axes of parallelism exploited by this package:
- ``gap``: batches of independent gap matrices (the reference stitches
  them serially, stitcher.hpp:157-203).
- ``lane``: one large DP matrix's anti-diagonal cut into lane blocks over
  several devices, with a halo passed to the right neighbour
  (sharded_gotoh.py).
- ``sub``: independent guide-tree siblings over worker processes
  (scheduler.py) or torch.distributed ranks (multiprocess.py); the
  reference executes them serially (src/execution.cpp:83-124).

Copy of centrolign_tpu/parallel/__init__.py; nothing here imports jax, so
the names need no lazy import.
"""

from .scheduler import distributed_execute  # noqa: F401
from .sharded_gotoh import (  # noqa: F401
    make_alignment_mesh, sharded_gotoh_align, sharded_gotoh_scores)
