"""`python -m cluster_anywhere_tpu_torch.analysis` == `ca lint`."""

import sys

from .lint import main

if __name__ == "__main__":  # importing the module (pkgutil walks) runs nothing
    sys.exit(main())
