"""python -m spmv_tpu_torch: the command line (see spmv_tpu_torch.cli)."""

import sys

from spmv_tpu_torch.cli import main

sys.exit(main())
