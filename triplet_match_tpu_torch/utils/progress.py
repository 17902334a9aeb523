"""Terminal progress bar (counterpart of ``triplet_match_tpu.utils.progress``).

Mirrors ``progress_bar`` (include/progress_bar:9-20, src/progress_bar.cpp:10-48):
``poll(done)`` renders a bar with an ANSI clear-line, ``finish()`` completes it.
"""

from __future__ import annotations

import sys


class ProgressBar:
    def __init__(self, prefix: str = "", width: int = 40, stream=None):
        self.prefix = prefix
        self.width = width
        self.stream = stream or sys.stderr
        self._finished = False

    def poll(self, done: float):
        """Render progress in [0, 1]."""
        done = min(max(done, 0.0), 1.0)
        filled = int(done * self.width)
        bar = "#" * filled + "-" * (self.width - filled)
        self.stream.write(f"\r\x1b[2K{self.prefix}[{bar}] {done * 100:5.1f}%")
        self.stream.flush()

    def finish(self):
        if not self._finished:
            self.poll(1.0)
            self.stream.write("\n")
            self.stream.flush()
            self._finished = True
