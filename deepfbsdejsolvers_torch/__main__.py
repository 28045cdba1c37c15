"""``python -m deepfbsdejsolvers_torch``: the experiment CLI."""

import sys

from deepfbsdejsolvers_torch.experiments.cli import main

if __name__ == "__main__":
    sys.exit(main())
