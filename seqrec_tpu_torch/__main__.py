import sys

from seqrec_tpu_torch.cli import main

sys.exit(main())
