"""Timestamped file+stdout logger (the port's own copy of
aocr/utils/logging_util.py).

Parity with the reference logger (`reference src/utils/logging.lua:5-45`):
timestamp-prefixed lines to both stdout and a flushed log file, with an
interactive Overwrite/Append/Abort prompt when the log file already exists
(logging.lua:9-24) — only when attached to a TTY; non-interactive runs
append.
"""

from __future__ import annotations

import os
import sys
import time


class Logger:
    def __init__(self, log_path: str):
        mode = "a"
        if os.path.exists(log_path) and sys.stdin.isatty():
            # reference key map (logging.lua:12-22): o/O overwrite, q/Q
            # abort, a/A or ANY other input appends; EOF aborts cleanly
            # (the reference would re-prompt forever there)
            try:
                ans = input(
                    f"Logging file {log_path} exists, "
                    f"Overwrite(o)? Append(a)? Abort(q)? "
                ).strip().lower()
            except EOFError:
                raise SystemExit(1)
            if ans == "o":
                mode = "w"
            elif ans == "q":
                raise SystemExit(1)
            else:
                mode = "a"
        d = os.path.dirname(log_path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.file = open(log_path, mode)

    def info(self, msg: str) -> None:
        line = time.strftime("%Y-%m-%d %H:%M:%S ") + str(msg)
        print(line, flush=True)
        self.file.write(line + "\n")
        self.file.flush()

    def shutdown(self) -> None:
        self.file.close()
