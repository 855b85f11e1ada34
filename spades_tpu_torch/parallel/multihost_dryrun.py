"""Multi-process dry-run worker: N processes, one rank each.

Run as `python -m spades_tpu_torch.parallel.multihost_dryrun --process-id I
--num-processes N --coordinator host:port --device cpu|cuda [--backend
gloo|nccl]` once per process; every process counts its `process_read_slice`
of a seeded read set through `count_kmers_sharded_multihost`, and process 0
checks the global count against the host oracle and prints MULTIHOST_OK.
The counterpart of `spades_tpu.parallel.multihost_dryrun` (the reference's
"multi-node simulated by N MPI ranks on one machine" smoke,
`.github/workflows/basic.yml:216-249`); `parallel/dryrun.py:dryrun_multihost`
starts the processes.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--coordinator", default="localhost:12765")
    ap.add_argument("--device", default=None, help="cpu or cuda (default: cuda)")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="default: nccl on cuda, gloo on the cpu")
    ap.add_argument("--k", type=int, default=15)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from spades_tpu_torch.core.reads import ReadBatch
    from spades_tpu_torch.ops.count import count_batch_host
    from spades_tpu_torch.parallel.distributed import (
        count_kmers_sharded_multihost,
        init_distributed,
        process_read_slice,
    )

    torch.set_num_threads(1)
    init_distributed(args.coordinator, args.num_processes, args.process_id,
                     backend=args.backend, device=args.device)
    assert dist.get_world_size() == args.num_processes
    rng = np.random.default_rng(7)
    # an odd read count: the ranks' slices differ in size
    n_reads = 8 * args.num_processes + 1
    reads = ["".join("ACGT"[i] for i in rng.integers(0, 4, 48)) for _ in range(n_reads)]
    lo, hi = process_read_slice(n_reads)
    kc = count_kmers_sharded_multihost(ReadBatch.from_sequences(reads[lo:hi]), args.k,
                                       device=args.device)
    # every process holds the same global result (SyncWorld analog)
    if args.process_id == 0:
        full = ReadBatch.from_sequences(reads)
        ref = count_batch_host(full.codes, full.lengths, full.n_mask, args.k)
        assert np.array_equal(kc.words, ref.words), "words mismatch vs oracle"
        assert np.array_equal(kc.counts, ref.counts), "counts mismatch vs oracle"
        print("MULTIHOST_OK", kc.num_unique, flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
