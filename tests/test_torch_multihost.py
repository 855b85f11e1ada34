"""Port parity for the multi-process set-up (`spades_tpu_torch.parallel.
distributed`, `multihost_dryrun`, `dryrun`).

`process_read_slice` must give the JAX package's slices; `init_distributed`
does nothing at one process and raises without a coordinator; the
two-process dry run (`python -m spades_tpu_torch.parallel.multihost_dryrun`
on gloo CPU processes, a TCP port taken by binding port 0) and
`dryrun_multigpu` at 2 and 3 ranks (count, extension masks and condense
against their single-device oracles) must pass.
"""
import numpy as np
import pytest
import torch.distributed as dist

from spades_tpu.parallel import distributed as j_dist
from spades_tpu_torch.parallel import distributed as t_dist
from spades_tpu_torch.parallel.dryrun import dryrun_multigpu, dryrun_multihost
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n_items", [0, 1, 7, 100, 262_144, 1_000_003])
@pytest.mark.parametrize("weights", [None, [3, 1], [1, 1, 1], [2, 5, 1, 1]])
def test_process_read_slice_matches_jax(n_items, weights):
    n_proc = len(weights) if weights else 4
    for pid in range(n_proc):
        want = j_dist.process_read_slice(n_items, pid, n_proc,
                                         weights=weights or [1] * n_proc)
        assert t_dist.process_read_slice(n_items, pid, n_proc, weights=weights) == want
    # the slices tile the input
    bounds = [t_dist.process_read_slice(n_items, p, n_proc, weights) for p in range(n_proc)]
    assert bounds[0][0] == 0 and bounds[-1][1] == n_items
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))


def test_process_read_slice_defaults_to_one_process():
    assert not dist.is_initialized()
    assert t_dist.process_read_slice(10) == (0, 10)


def test_init_distributed_at_one_process_and_without_a_coordinator(monkeypatch):
    for name in ("SPADES_COORDINATOR", "SPADES_NUM_PROCESSES", "SPADES_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    t_dist.init_distributed(device="cpu")
    t_dist.init_distributed(num_processes=1, device="cpu")
    assert not dist.is_initialized()
    assert t_dist.resolve_group() is None
    with pytest.raises(ValueError, match="coordinator"):
        t_dist.init_distributed(num_processes=2, process_id=0, device="cpu")
    monkeypatch.setenv("SPADES_NUM_PROCESSES", "3")
    with pytest.raises(ValueError, match="coordinator"):
        t_dist.init_distributed(device="cpu")
    monkeypatch.setenv("SPADES_COORDINATOR", "localhost:1")
    with pytest.raises(ValueError, match="process id"):
        t_dist.init_distributed(device="cpu")
    with pytest.raises(ValueError, match="outside"):
        t_dist.init_distributed(process_id=3, device="cpu")
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        t_dist.global_group()


def test_two_process_dryrun():
    out = dryrun_multihost(2, "cpu", timeout_s=240)
    assert "MULTIHOST_OK" in out


@pytest.mark.parametrize("world", [2, 3])
def test_dryrun_multigpu_on_cpu_ranks(world):
    got = dryrun_multigpu(world, "cpu", "gloo")
    assert got["world_size"] == world and len(got["shard_rows"]) == world
    assert np.all(np.asarray(got["shard_rows"]) > 0)
    assert got["de_clusters"] >= 1 and got["gaps_closed"] >= 1
