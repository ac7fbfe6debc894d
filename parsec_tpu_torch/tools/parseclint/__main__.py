import sys

from parsec_tpu_torch.tools.parseclint.engine import main

if __name__ == "__main__":
    sys.exit(main())
