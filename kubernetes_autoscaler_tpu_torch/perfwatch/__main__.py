import sys

from kubernetes_autoscaler_tpu_torch.perfwatch.cli import main

if __name__ == "__main__":
    sys.exit(main())
