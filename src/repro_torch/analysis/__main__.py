"""Entry point: ``python -m repro_torch.analysis src/repro_torch``."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
