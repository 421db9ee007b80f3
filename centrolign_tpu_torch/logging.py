"""Leveled stderr logging (reference logging.hpp:11-26).

Copy of centrolign_tpu/logging.py."""

import sys
import time

Silent = 0
Minimal = 1
Basic = 2
Verbose = 3
Debug = 4

level = Basic
_start = time.time()


def log(msg_level: int, msg: str) -> None:
    if msg_level <= level:
        elapsed = time.time() - _start
        h = int(elapsed // 3600)
        m = int(elapsed % 3600 // 60)
        s = elapsed % 60
        print(f"[centrolign_tpu] elapsed: {h}:{m:02d}:{s:04.1f} {msg}",
              file=sys.stderr)
