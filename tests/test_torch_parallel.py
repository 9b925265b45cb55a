"""The port's data-parallel path (arriba_tpu_torch/ops/cluster.py and
parallel/, plain PyTorch on the CPU) against the JAX package's: the
candidate clustering ops, the stats step and the three sharded steps at 1,
2, 4 and 8 row shards against the JAX steps on the 8-device virtual CPU
mesh of tests/conftest.py, the dry run of entry.py against the JAX dry
run's steps on the JAX pipeline's state of the same sample, and two gloo
ranks of parallel/multihost.py against one process. Inputs are made from
numpy seeds; everything is integer and exact except the binomial p-value
(see tests/test_torch_ops.py _assert_pvalues_match)."""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from arriba_tpu.ops import cluster as jax_cluster  # noqa: E402
from arriba_tpu.parallel import dp as jax_dp  # noqa: E402
from arriba_tpu.parallel import stats as jax_stats  # noqa: E402
from arriba_tpu_torch.ops import cluster  # noqa: E402
from arriba_tpu_torch.ops.encode import PAD_CODE, random_read_batch  # noqa: E402
from arriba_tpu_torch.parallel import dp, stats  # noqa: E402

from . import scenario  # noqa: E402
from .test_torch_ops import _assert_pvalues_match  # noqa: E402
from .test_torch_realign import _sw_rows  # noqa: E402

CPU = torch.device("cpu")
SHARDS = [1, 2, 4, 8]


def _jax_put(mesh):
    vec = NamedSharding(mesh, P("dp"))
    return lambda array: jax.device_put(jnp.asarray(array), vec)


# ---------------------------------------------------------------------------
# candidate clustering

def _candidates(seed, n, n_keys, draw=0):
    """n candidate slots drawing their keys from n_keys distinct fusion
    keys (the pool is the seed's, the draw the draw's); the last quarter of
    the slots are padding with junk keys, one valid key has gene words
    equal to the sentinel, and a few kinds fall outside [0, 3)."""
    rng = np.random.default_rng(seed)
    pool = np.stack([rng.integers(0, 50, n_keys), rng.integers(0, 50, n_keys),
                     rng.integers(0, 3, n_keys), rng.integers(0, 3, n_keys),
                     rng.integers(0, 10 ** 6, n_keys),
                     rng.integers(0, 10 ** 6, n_keys),
                     rng.integers(0, 2, n_keys), rng.integers(0, 2, n_keys)])
    pool[:2, 0] = cluster.SENTINEL
    rng = np.random.default_rng((seed, draw))
    cols = pool[:, rng.integers(0, n_keys, n)].astype(np.int32)
    kind = rng.integers(0, 3, n).astype(np.int32)
    kind[rng.integers(0, n, 2)] = 5
    valid = np.arange(n) < n - n // 4
    cols[:, ~valid] = rng.integers(0, 1000, (8, int((~valid).sum())))
    return cols, kind, valid


def _assert_tables_equal(got, want):
    for a, b in zip(got["words"], want["words"]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for key in ("support", "cluster_valid", "n_clusters"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)


@pytest.mark.parametrize("seed,n,n_keys", [(0, 64, 9), (1, 200, 60),
                                           (2, 48, 48)])
def test_cluster_candidates_matches_jax(seed, n, n_keys):
    cols, kind, valid = _candidates(seed, n, n_keys)
    words = cluster.pack_keys(*map(torch.from_numpy, cols))
    jax_words = jax_cluster.pack_keys(*map(jnp.asarray, cols))
    for a, b in zip(words, jax_words):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    got = cluster.cluster_candidates(words, torch.from_numpy(kind),
                                     torch.from_numpy(valid))
    want = jax_cluster.cluster_candidates(jax_words, jnp.asarray(kind),
                                          jnp.asarray(valid))
    _assert_tables_equal(got, want)
    assert 0 < int(got["n_clusters"]) < n


@pytest.mark.parametrize("seed", [3, 4])
def test_merge_cluster_tables_matches_jax(seed):
    """Two shards' tables concatenated, as the cluster step gathers them."""
    tables = []
    for draw in range(2):
        cols, kind, valid = _candidates(seed, 64, 12, draw)
        tables.append(cluster.cluster_candidates(
            cluster.pack_keys(*map(torch.from_numpy, cols)),
            torch.from_numpy(kind), torch.from_numpy(valid)))
    words = tuple(torch.cat([t["words"][i] for t in tables])
                  for i in range(6))
    support = torch.cat([t["support"] for t in tables])
    valid = torch.cat([t["cluster_valid"] for t in tables])
    got = cluster.merge_cluster_tables(words, support, valid)
    want = jax_cluster.merge_cluster_tables(
        tuple(jnp.asarray(w.numpy()) for w in words),
        jnp.asarray(support.numpy()), jnp.asarray(valid.numpy()))
    _assert_tables_equal(got, want)
    assert int(got["n_clusters"]) < int(valid.sum())


# ---------------------------------------------------------------------------
# the stats step and the three sharded steps at 1, 2, 4 and 8 shards

def _stats_inputs(seed, n_rows=128, n_genes=24, n_hits=200):
    """Pre-marshalled stats-step inputs: colliding genes and breakpoints
    (so both dedups act), a padded tail, a few dummy genes."""
    rng = np.random.default_rng(seed)
    n_valid = n_rows - 5
    cols = {
        "valid": np.arange(n_rows) < n_valid,
        "none": rng.random(n_rows) < 0.8,
        "index": np.arange(n_rows, dtype=np.int32),
    }
    for name, high in (("gene1", n_genes), ("gene2", n_genes),
                       ("contig1", 3), ("contig2", 3), ("split", 4),
                       ("sup", 5)):
        cols[name] = rng.integers(0, high, n_rows).astype(np.int32)
    cols["bp1"] = rng.choice([1000, 2000, 700000], n_rows).astype(np.int32)
    cols["bp2"] = rng.choice([1500, 300000, 1300000], n_rows).astype(np.int32)
    for name, p in (("dir1", 0.5), ("dir2", 0.5), ("spliced1", 0.4),
                    ("spliced2", 0.4), ("exonic1", 0.5), ("exonic2", 0.5),
                    ("dummy1", 0.05), ("dummy2", 0.05)):
        cols[name] = rng.random(n_rows) < p
    inputs = {f"col_{k}": v for k, v in cols.items()}
    inputs["hits"] = rng.integers(0, n_genes, n_hits).astype(np.int32)
    inputs["hits_valid"] = np.arange(n_hits) < n_hits - 7
    inputs["n_genes"] = np.int64(n_genes)
    return inputs


@pytest.mark.parametrize("n", SHARDS)
def test_stats_step_matches_jax(n):
    inputs = _stats_inputs(5)
    got = stats.run_stats_step(dp.make_mesh(n, CPU), inputs)
    mesh = jax_dp.make_mesh(n)
    want = jax_stats.run_stats_step(mesh, inputs, _jax_put(mesh))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                      err_msg=key)
    assert got["partner_count"].sum() > 0 and got["expression"].sum() > 0
    assert sum(int(got[key]) > 0 for key in stats.COUNTERS) >= 6


@pytest.mark.parametrize("n", SHARDS)
def test_read_filter_step_matches_jax(n):
    batch = random_read_batch(np.random.default_rng(7), 100, 152,
                              mismatch_rate=0.03)
    mesh = dp.make_mesh(n, CPU)
    sharded = dp.shard_batch(batch, mesh)
    n_rows = sharded.bases.shape[0]
    per_read, globals_ = dp.sharded_read_filter_step(mesh)(
        sharded.bases, sharded.ref, sharded.match_mask, sharded.length,
        sharded.aligned_start, sharded.aligned_end,
        torch.zeros(n_rows, dtype=torch.int32))
    jax_mesh = jax_dp.make_mesh(n)
    jsharded = jax_dp.shard_batch(batch, jax_mesh)
    want, want_globals = jax_dp.sharded_read_filter_step(jax_mesh)(
        jsharded.bases, jsharded.ref, jsharded.match_mask, jsharded.length,
        jsharded.aligned_start, jsharded.aligned_end,
        jnp.zeros(n_rows, jnp.int32))
    got = {key: value.numpy() for key, value in per_read.items()}
    want = {key: np.asarray(value) for key, value in want.items()}
    assert n_rows == len(want["pvalue"])
    for key in ("mismatches", "alignment_length", "low_entropy_discard"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    real = slice(0, batch.n_reads)
    _assert_pvalues_match(got["pvalue"][real], want["pvalue"][real],
                          got["alignment_length"][real], 0.01,
                          got["mismatch_discard"][real],
                          want["mismatch_discard"][real])
    for key, value in want_globals.items():
        if key != "discarded_mismatch":
            assert int(globals_[key]) == int(value), key
    valid = got["alignment_length"] > 0
    assert int(globals_["discarded_mismatch"]) == int(
        got["mismatch_discard"][valid].sum())
    assert int(globals_["total_reads"]) == batch.n_reads


@pytest.mark.parametrize("n", SHARDS)
def test_realign_step_matches_jax(n):
    reads, windows = _sw_rows(9, 64, 48, 80)
    length = (reads != PAD_CODE).sum(axis=1).astype(np.int32)
    mesh = dp.make_mesh(n, CPU)
    result, total = dp.sharded_realign_step(mesh)(
        *(mesh.put(x) for x in (reads, windows, length)))
    jax_mesh = jax_dp.make_mesh(n)
    put = _jax_put(jax_mesh)
    want, want_total = jax_dp.sharded_realign_step(jax_mesh)(
        put(reads), jax.device_put(jnp.asarray(windows),
                                   NamedSharding(jax_mesh, P("dp", None))),
        put(length))
    for key in ("seed_hit", "sw_score", "can_align"):
        np.testing.assert_array_equal(result[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    assert int(total) == int(want_total) > 0


# ---------------------------------------------------------------------------
# the dry run on real pipeline data

def _jax_run_all(batch, fusion_list, state, options, n):
    """__graft_entry__.py:112-169, the JAX dry run's steps at n devices."""
    from arriba_tpu.filters.in_vitro import expression_gene_incidence

    mesh = jax_dp.make_mesh(n)
    sharded = jax_dp.shard_batch(batch, mesh)
    n_rows = sharded.bases.shape[0]
    per_read, globals_ = jax_dp.sharded_read_filter_step(mesh)(
        sharded.bases, sharded.ref, sharded.match_mask, sharded.length,
        sharded.aligned_start, sharded.aligned_end,
        jnp.zeros(n_rows, jnp.int32))
    result, total_alignable = jax_dp.sharded_realign_step(mesh)(
        jnp.asarray(sharded.bases), jnp.asarray(sharded.ref[:, :256]),
        sharded.length)
    cols, kind, valid = jax_stats.candidate_cluster_inputs(fusion_list, n)
    put = _jax_put(mesh)
    words = tuple(put(w) for w in jax_cluster.pack_keys(
        *(jnp.asarray(c) for c in cols)))
    clusters = jax_dp.sharded_cluster_step(mesh)(words, put(kind), put(valid))
    n_clusters = int(clusters["n_clusters"])
    cascade_stats, (expression, threshold) = jax_stats.compute_stats_sharded(
        fusion_list, state.annotation.genes,
        expression_gene_incidence(state.chimeric_alignments),
        options.high_expression_quantile, mesh)
    return {
        "per_read": {k: np.asarray(v)[:batch.n_reads]
                     for k, v in per_read.items()},
        "globals": {k: int(v) for k, v in globals_.items()},
        "realign": {k: np.asarray(v)[:batch.n_reads]
                    for k, v in result.items()},
        "total_alignable": int(total_alignable), "n_clusters": n_clusters,
        "clusters": {"words": tuple(np.asarray(w)[:n_clusters]
                                    for w in clusters["words"]),
                     "support": np.asarray(clusters["support"])[:n_clusters]},
        "stats": cascade_stats, "expression": expression,
        "expression_threshold": threshold}


def _run_pipeline(package, env_name, args, out):
    import importlib

    cli = importlib.import_module(f"{package}.cli")
    pipeline = importlib.import_module(f"{package}.pipeline")
    options = cli.parse_arguments(args + ["-o", str(out)])
    saved = os.environ.get(env_name)
    os.environ[env_name] = "1"
    try:
        return pipeline.run(options), options
    finally:
        if saved is None:
            del os.environ[env_name]
        else:
            os.environ[env_name] = saved


@pytest.fixture(scope="module")
def sample_states(tmp_path_factory):
    """multi_event_sample through both packages' pipelines with the Python
    event stages (the whole candidate table is kept)."""
    tmp = tmp_path_factory.mktemp("dp_sample")
    args = scenario.multi_event_sample(tmp)
    saved = os.environ.get("ARRIBA_TPU_TORCH_DEVICE")
    os.environ["ARRIBA_TPU_TORCH_DEVICE"] = "cpu"
    try:
        port = _run_pipeline("arriba_tpu_torch",
                             "ARRIBA_TPU_TORCH_NO_NATIVE_EVENT", args,
                             tmp / "torch.tsv")
    finally:
        if saved is None:
            del os.environ["ARRIBA_TPU_TORCH_DEVICE"]
        else:
            os.environ["ARRIBA_TPU_TORCH_DEVICE"] = saved
    reference = _run_pipeline("arriba_tpu", "ARRIBA_TPU_NO_NATIVE_EVENT",
                              args, tmp / "jax.tsv")
    return args, port, reference


@pytest.mark.parametrize("n", [1, 4])
def test_dryrun_matches_jax_dryrun_steps(sample_states, monkeypatch, n):
    """dryrun_multichip passes its own checks at n shards, and the steps it
    runs give on the port's state what the JAX dry run's steps give on the
    JAX package's state of the same sample."""
    from arriba_tpu.ops.encode import tensorize as jax_tensorize
    from arriba_tpu_torch.entry import dryrun_multichip, sharded_steps
    from arriba_tpu_torch.ops.encode import tensorize

    args, (state, options), (jax_state, jax_options) = sample_states
    monkeypatch.setenv("ARRIBA_TPU_TORCH_DEVICE", "cpu")
    dryrun_multichip(n, args)

    batch = tensorize(state.chimeric_alignments, state.assembly)
    jax_batch = jax_tensorize(jax_state.chimeric_alignments,
                              jax_state.assembly)
    for field in ("bases", "ref", "match_mask", "length"):
        np.testing.assert_array_equal(getattr(batch, field),
                                      getattr(jax_batch, field))
    got, _ = sharded_steps(batch, list(state.fusions.values()), state,
                           options, n, CPU)
    want = _jax_run_all(jax_batch, list(jax_state.fusions.values()),
                        jax_state, jax_options, n)
    for key in ("mismatches", "alignment_length", "low_entropy_discard"):
        np.testing.assert_array_equal(got["per_read"][key],
                                      want["per_read"][key], err_msg=key)
    _assert_pvalues_match(got["per_read"]["pvalue"],
                          want["per_read"]["pvalue"],
                          got["per_read"]["alignment_length"], 0.01,
                          got["per_read"]["mismatch_discard"],
                          want["per_read"]["mismatch_discard"])
    for key in want["realign"]:
        np.testing.assert_array_equal(got["realign"][key],
                                      want["realign"][key], err_msg=key)
    for key in ("total_alignable", "n_clusters", "expression_threshold"):
        assert got[key] == want[key], key
    assert got["globals"]["total_mismatches"] == \
        want["globals"]["total_mismatches"]
    for a, b in zip(got["clusters"]["words"], want["clusters"]["words"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["clusters"]["support"],
                                  want["clusters"]["support"])
    np.testing.assert_array_equal(got["expression"], want["expression"])
    for name in got["stats"].__slots__:
        np.testing.assert_array_equal(getattr(got["stats"], name),
                                      getattr(want["stats"], name),
                                      err_msg=name)
    assert got["total_alignable"] > 0 and got["n_clusters"] > 0


def test_multihost_gloo_matches_one_process(sample_states):
    """Two gloo ranks with two shards each: the merged cluster count, every
    statistic and the expression counts equal the single-process result."""
    from arriba_tpu_torch.filters.in_vitro import expression_gene_incidence
    from arriba_tpu_torch.parallel.multihost import run_multiprocess_stats

    _, (state, options), _ = sample_states
    fusion_list = list(state.fusions.values())
    incidence = expression_gene_incidence(state.chimeric_alignments)
    quantile = options.high_expression_quantile
    got_stats, got_expression, n_clusters = run_multiprocess_stats(
        fusion_list, state.annotation.genes, incidence, quantile,
        n_processes=2, shards_per_process=2, device=CPU, timeout=240)
    want_stats, want_expression = stats.compute_stats_sharded(
        fusion_list, state.annotation.genes, incidence, quantile,
        dp.make_mesh(1, CPU))
    assert got_stats == want_stats
    np.testing.assert_array_equal(got_expression[0], want_expression[0])
    assert got_expression[1] == want_expression[1]
    assert n_clusters == sum(1 for f in fusion_list
                             if f.split_read1_list or f.split_read2_list
                             or f.discordant_mate_list) > 0
