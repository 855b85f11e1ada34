"""Port parity for the sharded distance estimation
(`spades_tpu_torch.parallel.sharded_de`).

gloo CPU ranks of one `RankPool` per world size (1, 2, 4) and the port in
this process without a group, against the JAX package's
`estimate_simple_sharded` on its 8-device virtual mesh: e1 and e2 exact,
dist and weight within rtol 1e-5 (float32 sums in another order, the JAX
package's own tolerance against its host estimator).
"""
import dataclasses

import numpy as np
import pytest

from spades_tpu.paired.distance_estimation import DEConfig as JConfig
from spades_tpu.paired.paired_info import PairedIndex as JIndex
from spades_tpu.parallel import sharded_count as j_sc
from spades_tpu.parallel import sharded_de as j_de
from spades_tpu_torch import convert
from spades_tpu_torch.paired.distance_estimation import DEConfig
from spades_tpu_torch.parallel.dryrun import RankPool
from spades_tpu_torch.parallel.sharded_de import estimate_simple_sharded
from tests.test_torch_pipeline import one_torch_thread  # noqa: F401

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    d = tmp_path_factory.mktemp("store")
    made = {w: RankPool(w, "cpu", "gloo", f"file://{d}/w{w}", timeout_s=300) for w in WORLDS}
    yield made
    for p in made.values():
        p.close()


def _random_table(rng, n_pairs=200, rows_per_pair=6):
    e1, e2, d, w = [], [], [], []
    for _ in range(n_pairs):
        a, b = int(rng.integers(0, 500)), int(rng.integers(0, 500))
        base = int(rng.integers(50, 400))
        for _r in range(int(rng.integers(1, rows_per_pair))):
            e1.append(a)
            e2.append(b)
            d.append(base + int(rng.integers(0, 40)) + 0.5 * int(rng.integers(0, 2)))
            w.append(float(rng.integers(1, 5)))
    o = np.lexsort((d, e2, e1))
    return {"e1": np.asarray(e1, np.int64)[o], "e2": np.asarray(e2, np.int64)[o],
            "dist": np.asarray(d, float)[o], "weight": np.asarray(w, float)[o]}


def _tables():
    rng = np.random.default_rng(3)
    n = 300
    return {
        "random": _random_table(rng),
        "empty": {"e1": np.zeros(0, np.int64), "e2": np.zeros(0, np.int64),
                  "dist": np.zeros(0), "weight": np.zeros(0)},
        # one group of many rows: one owner, the other ranks cluster nothing
        "single_heavy_group": {"e1": np.zeros(n, np.int64), "e2": np.ones(n, np.int64),
                               "dist": (np.arange(n) * 2).astype(float),
                               "weight": np.ones(n)},
        "gaps_and_light_clusters": _random_table(np.random.default_rng(9), 300, 3),
    }


def _assert_close(got, ref):
    assert np.array_equal(got.e1, ref.e1) and np.array_equal(got.e2, ref.e2)
    np.testing.assert_allclose(got.dist, ref.dist, rtol=1e-5)
    np.testing.assert_allclose(got.weight, ref.weight, rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("table", list(_tables()))
def test_clusters_match_jax(pools, table, world):
    d = _tables()[table]
    cfg = DEConfig(linkage_distance=10, min_peak_weight=3.0)
    ref = j_de.estimate_simple_sharded(JIndex(d["e1"], d["e2"], d["dist"], d["weight"]),
                                       j_sc.make_mesh(8), JConfig(**dataclasses.asdict(cfg)))
    pi = convert.paired_index_from_arrays(d)
    _assert_close(estimate_simple_sharded(pi, cfg=cfg, device="cpu"), ref)
    for got in pools[world].run(estimate_simple_sharded, pi, group="world", cfg=cfg,
                                device="cpu"):
        _assert_close(got, ref)
    if table == "single_heavy_group":
        assert ref.e1.size >= 1
