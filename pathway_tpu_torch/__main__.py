"""``python -m pathway_tpu_torch`` runs the command line (``cli.py``)."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
