"""`python -m weatherforecast_stgcn_maml_tpu_torch` -> the CLI."""

import sys

from weatherforecast_stgcn_maml_tpu_torch.cli import main

sys.exit(main())
