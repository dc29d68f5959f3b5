"""``python -m repro_torch.obs`` — the BENCH regression gate CLI."""

import sys

from .regress import main

if __name__ == "__main__":
    sys.exit(main())
