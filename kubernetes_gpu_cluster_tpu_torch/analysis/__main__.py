"""``python -m kubernetes_gpu_cluster_tpu_torch.analysis`` ==
``kgct-torch-lint``. Importing the module runs nothing."""

import sys

from .cli import main

if __name__ == "__main__":
    sys.exit(main())
