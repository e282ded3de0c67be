"""``python -m corrosion_tpu_torch``: the command line."""

import sys

from corrosion_tpu_torch.cli import main

sys.exit(main())
