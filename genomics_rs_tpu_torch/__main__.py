import sys

from genomics_rs_tpu_torch.cli import main

sys.exit(main())
