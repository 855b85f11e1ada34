"""`coronaspades.py` wrapper — see `spades_tpu_torch.pipeline.wrappers`."""
import sys

from .wrappers import coronaspades as main

if __name__ == "__main__":
    sys.exit(main())
