"""Entry point: ``python -m repro_torch.diff``, the policy trainer's CLI
(the same as ``python -m repro_torch.diff.train``)."""

import sys

from .train import main

if __name__ == "__main__":
    sys.exit(main())
