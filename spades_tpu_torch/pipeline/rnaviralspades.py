"""`rnaviralspades.py` wrapper — see `spades_tpu_torch.pipeline.wrappers`."""
import sys

from .wrappers import rnaviralspades as main

if __name__ == "__main__":
    sys.exit(main())
