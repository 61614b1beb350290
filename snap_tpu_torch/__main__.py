"""python -m snap_tpu_torch {index,single} ...: the CLI on the CUDA card."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
