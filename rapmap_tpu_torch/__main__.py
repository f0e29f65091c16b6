"""`python -m rapmap_tpu_torch ...` is `python -m rapmap_tpu_torch.cli ...`."""

import sys

from rapmap_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
