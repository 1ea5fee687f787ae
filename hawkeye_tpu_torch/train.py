"""Train entry point: ``python -m hawkeye_tpu_torch.train --config <yaml>``.

Runs the base Trainer on the CUDA device (no flag needed); ``--device cpu``
runs it on the CPU instead. The Example trainers (``examples/``) run
through ``main`` with their own Trainer class.
"""

from __future__ import annotations

import argparse

from . import models  # noqa: F401  (registry side effects)
from .config import setup_config
from .engine import Trainer


def main(argv=None, trainer_cls=Trainer):
    parser = argparse.ArgumentParser(description="Hawkeye (PyTorch) training")
    parser.add_argument("--device", default=None,
                        help="torch device; CUDA when not given")
    args, _ = parser.parse_known_args(argv)
    trainer_cls(setup_config(argv), device=args.device).train()


if __name__ == "__main__":
    main()
