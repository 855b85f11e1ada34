"""Mode wrapper entry points (metaspades.py, plasmidspades.py ... analogs).

SPAdes ships thin wrappers that run spades.py with a mode flag
(`src/projects/spades/pipeline/metaspades.py` etc.); these modules do the
same for `python -m spades_tpu_torch.pipeline.<wrapper>`.  The wrappers of
the modes not ported yet (rnaspades, rnaviralspades: ROADMAP A13e;
coronaspades: A13f) are not here.
"""
from __future__ import annotations

import sys

from .main import main as _main


def _wrap(flag: str, argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    return _main([flag] + argv)


def metaspades(argv=None) -> int:
    return _wrap("--meta", argv)


def plasmidspades(argv=None) -> int:
    return _wrap("--plasmid", argv)


def metaplasmidspades(argv=None) -> int:
    return _wrap("--metaplasmid", argv)


def metaviralspades(argv=None) -> int:
    return _wrap("--metaviral", argv)
