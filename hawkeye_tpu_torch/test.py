"""Eval entry point: ``python -m hawkeye_tpu_torch.test --config <yaml>``.

Runs the Tester on the CUDA device (no flag needed); ``--device cpu`` runs
it on the CPU instead. ``model.load`` names the weights; a recipe's
``.msgpack`` name reads the ``.pt`` file of the same stem.
"""

from __future__ import annotations

import argparse

from . import models  # noqa: F401  (registry side effects)
from .config import setup_config
from .engine import Tester


def main(argv=None):
    parser = argparse.ArgumentParser(description="Hawkeye (PyTorch) evaluation")
    parser.add_argument("--device", default=None,
                        help="torch device; CUDA when not given")
    args, _ = parser.parse_known_args(argv)
    return Tester(setup_config(argv), device=args.device).test()


if __name__ == "__main__":
    main()
