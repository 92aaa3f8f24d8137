"""``python -m repro_torch.analysis`` — run zipnn-lint over the repo."""

import sys

from .driver import main

sys.exit(main())
