"""Logger setup: tqdm-friendly screen handler + file handler.

Reference: ``utils/utils.py:69-76`` (TqdmHandler — which sleeps 1 s per emit;
we drop that artificial delay) and ``train.py:116-132`` (get_logger wiring).
"""

from __future__ import annotations

import logging
import os
import sys


class TqdmHandler(logging.StreamHandler):
    """Screen handler that cooperates with tqdm progress bars."""

    def emit(self, record):
        try:
            from tqdm import tqdm

            msg = self.format(record)
            tqdm.write(msg)
            self.flush()
        except Exception:
            super().emit(record)


def get_logger(name="hawkeye", log_dir=None, filename="report.log"):
    logger = logging.getLogger(name)
    logger.handlers = []
    logger.setLevel(logging.INFO)
    logger.propagate = False

    fmt = logging.Formatter("[%(asctime)s] %(message)s", datefmt="%Y-%m-%d %H:%M:%S")

    screen = TqdmHandler(sys.stdout)
    screen.setFormatter(fmt)
    logger.addHandler(screen)

    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, filename))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
