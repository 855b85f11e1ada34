"""spades-convert-bin-to-fasta equivalent: binary reads -> FASTA.

Reference: SPAdes `src/projects/spades_tools/convert_bin_to_fasta.cpp:108`.  Host code.

    python -m spades_tpu_torch.tools.convert_bin_to_fasta bin_reads_dir -w out
"""
from __future__ import annotations

import glob
import os
import sys

from .common import make_parser, setup


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-convert-bin-to-fasta", __doc__.split("\n")[0])
    p.add_argument("bin_reads_dir", help="directory with reads_*.bin chunks (or one .bin file)")
    args = p.parse_args(argv)
    setup(args)

    from ..io.binary_reads import read_binary_reads
    from ..io.fastx import write_fasta

    if os.path.isdir(args.bin_reads_dir):
        files = sorted(glob.glob(os.path.join(args.bin_reads_dir, "*.bin")))
    else:
        files = [args.bin_reads_dir]
    if not files:
        print("no .bin files found", file=sys.stderr)
        return 1
    os.makedirs(args.workdir, exist_ok=True)
    out = os.path.join(args.workdir, "reads.fasta")
    n = 0
    records = []
    for f in files:
        for s in read_binary_reads(f):
            n += 1
            records.append((f"read{n}", s))
    write_fasta(out, records)
    print(f"{n} reads -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
