"""``python -m cs744_pytorch_distributed_tutorial_tpu_torch.analysis`` entry."""

import sys

from cs744_pytorch_distributed_tutorial_tpu_torch.analysis.cli import main

sys.exit(main())
