"""The port's multi-device meshes (``parallel/``) on CPU ranks: gloo process
groups of 1, 2 and 4 ranks spawned by ``parallel.distributed.run_local``,
against the port's single-device round and the JAX package's sharded rounds
on the same mesh shapes (JAX on conftest's virtual CPU devices, Pallas in
interpret mode), with JAX's per-chunk words (``fold_in(key, chunk)``) handed
to the port as ``RoundDraws``.  The fixture is tests/test_parallel2d.py's
(960-point box, 1360-point scene, its policy).

The rank functions below import no JAX: a spawned rank imports this module
to find them.
"""

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from triplet_match_tpu_torch import api
from triplet_match_tpu_torch import config as tcfg
from triplet_match_tpu_torch.cli import match as cli
from triplet_match_tpu_torch.core.cloud import PointCloud
from triplet_match_tpu_torch.core.transforms import pose_delta
from triplet_match_tpu_torch.index.model import compiled_model_from_numpy
from triplet_match_tpu_torch.parallel import distributed as pdist
from triplet_match_tpu_torch.parallel import mesh as pmesh
from triplet_match_tpu_torch.parallel import search as psearch
from triplet_match_tpu_torch.parallel import search2d as p2d
from triplet_match_tpu_torch.search import driver as td
from triplet_match_tpu_torch.search import score as tscore
from triplet_match_tpu_torch.search import score_kernel as tsk
from triplet_match_tpu_torch.search.sampling import RoundDraws

torch.set_num_threads(2)

KNOBS = dict(num_first_samples=32, num_second_samples=8, query_cap=8, score_neighbors=256,
             second_pool=64, finalists=4, max_rounds=2)  # tests/test_parallel2d.py's POLICY
TPOLICY = dataclasses.replace(tcfg.SearchPolicy(), **KNOBS)
TSAMPLE = tcfg.SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95)
TDISC = tcfg.DiscretizationParams()
# the fog route's join: prescreen, candidate-subset join, edge-anchored ranking
# (test_join_subset_sp_round_matches_full_join's knobs)
FOG = dict(finalists=6, finalist_prescreen=2, join_subset_capacity=512, rank_edges_only=True,
           tight_edges_only=True)
ROUND = dict(discretization=TDISC, sample_params=TSAMPLE, max_icp_iterations=5)
N_SCENE = -(-(960 + 400) // 8) * 8


# --- rank functions (spawned processes: torch and the port only) ---------------------


def _port_inputs(spec):
    model = compiled_model_from_numpy(spec["model"], device="cpu")
    s = spec["scene"]
    cloud = PointCloud.from_arrays(s["xyz"], s["normal"], s["tangent"], s["valid"], device="cpu")
    tm = torch.from_numpy(s["tangent_mask"])
    prep = td.ScenePrep(cloud=cloud, tangent_mask=tm, n_edge=tm.sum())
    return model, prep


def _draws(words):
    return [RoundDraws(w[0], w[1], w[2], torch.from_numpy(w[3])) for w in words]


def _mesh(shape):
    if len(shape) == 1:
        return pmesh.make_mesh(shape[0], device_type="cpu")
    if len(shape) == 2:
        return p2d.make_mesh_2d(*shape, device_type="cpu")
    return p2d.make_mesh_3d(*shape, device_type="cpu")


def _numpy(res, cons, fp):
    return {"transform": res.transform.numpy(), "accept": res.accept.numpy(),
            "count": res.count.numpy(), "new_corr": res.new_corr.numpy(),
            "model_idx": res.model_idx.numpy(), "hypotheses": int(res.hypotheses_scored),
            "join_overflow": int(res.join_overflow), "consumed": cons.numpy(),
            "fp": fp.numpy()}


def _rank_rounds(spec):
    """Every run of ``spec["runs"]`` (name, mesh shape, policy knobs) as one
    round of its mesh; returns every rank's outputs (gathered to rank 0)."""
    torch.set_num_threads(1)
    model, prep = _port_inputs(spec)
    n = prep.cloud.capacity
    out = {}
    for name, shape, knobs in spec["runs"]:
        mesh = _mesh(shape)
        policy = dataclasses.replace(TPOLICY, **knobs)
        mpack = tsk.pack_model_cached(model, coarse_points=policy.coarse_model_points,
                                      fine_points=policy.fine_model_points)
        fn = psearch.search_round_dp if len(shape) == 1 else p2d.search_round_2d_prep
        zeros = torch.zeros(n, dtype=torch.bool)
        out[name] = _numpy(*fn(mesh, model, prep, zeros, zeros.clone(), _draws(spec["draws"]),
                               3.0, 0.5, mpack, policy=policy, **ROUND))
    if "extra" in spec:  # the mesh scene preparation and the sharded finish_find
        mesh = _mesh((dist.get_world_size(),))
        p = td.prepare_scene(prep.cloud, TPOLICY, mesh=mesh)
        out["prep_mask"] = p.tangent_mask.numpy()
        t = torch.from_numpy(spec["extra"]["t"])
        ff = psearch.finish_find_sp(mesh, model, prep.cloud, prep.tangent_mask,
                                    torch.zeros(n, dtype=torch.bool), t, 3.0)
        out["ff"] = {"count": int(ff.count), "score": float(ff.score),
                     "valid": pmesh.all_gather(ff.valid, mesh, "chips").numpy(),
                     "model_idx": pmesh.all_gather(ff.model_idx, mesh, "chips").numpy()}
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, out)
    return gathered


def _rank_cli(argv, policy):
    cli.POLICY = policy
    return cli.main(argv)


# --- fixtures ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    from triplet_match_tpu.config import DiscretizationParams, SampleParams, SearchPolicy
    from triplet_match_tpu.core.cloud import PointCloud as JCloud
    from triplet_match_tpu.index.model import compile_model
    from triplet_match_tpu.index.serialize import _CLOUD_FIELDS, _MODEL_FIELDS
    from triplet_match_tpu.io.synthetic import embed_in_scene, make_box_model
    from triplet_match_tpu.search.driver import prepare_scene

    xyz, nrm, tan = make_box_model(n_edge=240, n_face=720, size=(1.0, 0.8, 0.6), seed=0)
    jpol = SearchPolicy(scorer="pallas", pallas_interpret=True, **KNOBS)
    jm = compile_model(JCloud.from_arrays(xyz, nrm, tan), DiscretizationParams(),
                       SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95), jpol,
                       pair_block=128)
    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=400,
                                    clutter_extent=5.0, seed=11, capacity=N_SCENE)
    jprep = prepare_scene(scene, jpol)
    model = {f"cloud_{k}": np.asarray(getattr(jm.cloud, k)) for k in _CLOUD_FIELDS}
    model.update({k: np.asarray(getattr(jm, k)) for k in _MODEL_FIELDS})
    model["margin"] = jm.margin
    sc = {f: np.array(getattr(jprep.cloud, f)) for f in ("xyz", "normal", "tangent", "valid")}
    sc["tangent_mask"] = np.array(jprep.tangent_mask)
    return SimpleNamespace(jm=jm, jprep=jprep, jpol=jpol, t_gt=np.asarray(t_gt), model=model,
                           scene=sc, xyz=xyz, nrm=nrm, tan=tan, raw_scene=scene)


def _chunk_words(key, chunks: int):
    """The port's RoundDraws words of chunk c = JAX's ``fold_in(key, c)``."""
    import jax

    out = []
    for c in range(chunks):
        k1, k2, k3, k4 = jax.random.split(jax.random.fold_in(key, c), 4)

        def words(k, salt):
            return tuple(int(v) for v in
                         np.asarray(jax.random.key_data(jax.random.fold_in(k, salt))).reshape(-1))

        g = np.array(jax.random.gumbel(k2, (KNOBS["num_first_samples"], KNOBS["second_pool"])))
        out.append((words(k1, 1), words(k3, 0), words(k4, 0), g))
    return out


@pytest.fixture(scope="module")
def jax_rounds(setup):
    """The JAX package's sharded rounds on (1, 2) and (2, 2), key PRNGKey(7)."""
    import jax
    import jax.numpy as jnp

    from triplet_match_tpu.config import DiscretizationParams, SampleParams
    from triplet_match_tpu.parallel.search2d import make_mesh_2d, search_round_2d
    from triplet_match_tpu.search import score_pallas as jsp

    mpack = jsp.pack_model_cached(setup.jm, coarse_points=setup.jpol.coarse_model_points,
                                  fine_points=setup.jpol.fine_model_points)
    n = setup.jprep.cloud.xyz.shape[0]
    out = {}
    for shape in ((1, 2), (2, 2)):
        res, cons, fp = jax.jit(functools.partial(
            search_round_2d, make_mesh_2d(*shape), discretization=DiscretizationParams(),
            sample_params=SampleParams(min_diameter_factor=0.3, max_diameter_factor=0.95),
            policy=setup.jpol, max_icp_iterations=5))(
            setup.jm, setup.jprep.cloud, setup.jprep.tangent_mask, jnp.zeros(n, bool),
            jnp.zeros(n, bool), jax.random.PRNGKey(7), jnp.float32(3.0), jnp.float32(0.5),
            mpack)
        out[shape] = {"transform": np.asarray(res.transform), "accept": np.asarray(res.accept),
                      "count": np.asarray(res.count), "new_corr": np.asarray(res.new_corr),
                      "hypotheses": int(res.hypotheses_scored), "consumed": np.asarray(cons),
                      "fp": np.asarray(fp)}
    return out


@pytest.fixture(scope="module")
def words(setup):
    import jax

    return _chunk_words(jax.random.PRNGKey(7), 2)


@pytest.fixture(scope="module")
def single(setup, words):
    """The port's single-device round with chunk 0's draws."""
    model, prep = _port_inputs({"model": setup.model, "scene": setup.scene})
    mpack = tsk.pack_model_cached(model, coarse_points=TPOLICY.coarse_model_points,
                                  fine_points=TPOLICY.fine_model_points)
    zeros = torch.zeros(prep.cloud.capacity, dtype=torch.bool)
    return _numpy(*td.search_round(model, prep, zeros, zeros.clone(), _draws(words)[0], 3.0, 0.5,
                                   mpack, policy=TPOLICY, **ROUND))


@pytest.fixture(scope="module")
def two_ranks(setup, words):
    t = np.linalg.inv(setup.t_gt).astype(np.float32)
    spec = {"model": setup.model, "scene": setup.scene, "draws": words, "extra": {"t": t},
            "runs": [("12", (1, 2), {}), ("2", (2,), {}), ("21", (2, 1), {})]}
    return pdist.run_local(_rank_rounds, 2, "gloo", spec, device_type="cpu"), t


@pytest.fixture(scope="module")
def four_ranks(setup, words):
    import jax

    spec = {"model": setup.model, "scene": setup.scene,
            "draws": _chunk_words(jax.random.PRNGKey(7), 4),
            "runs": [("22", (2, 2), {}), ("22fog", (2, 2), FOG), ("212fog", (2, 1, 2), FOG)]}
    return pdist.run_local(_rank_rounds, 4, "gloo", spec, device_type="cpu")


# --- helpers -------------------------------------------------------------------------


def _orthonormal(t) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(t, np.float64)).clone()
    u, _, vt = torch.linalg.svd(t[..., :3, :3])
    t[..., :3, :3] = u @ vt
    return t


def _same_round(got, ref, *, fields=("accept", "count", "new_corr", "consumed", "fp",
                                     "hypotheses")):
    """Integer outputs equal, poses within the single-round tolerance of
    tests/test_torch_round.py (1e-4 and 0.01 deg)."""
    for f in fields:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)
    dt, dr = pose_delta(_orthonormal(ref["transform"]), _orthonormal(got["transform"]))
    assert float(dt.max()) < 1e-4
    assert float(np.degrees(float(dr.max()))) < 0.01


def _found(setup, res):
    from triplet_match_tpu_torch.core.transforms import invert_rigid
    from triplet_match_tpu_torch.io.synthetic import sym_delta

    accept = res["accept"]
    assert accept.any()
    f = int(np.argmax(res["count"] * accept))
    t = invert_rigid(torch.from_numpy(res["transform"][f])).numpy()
    dt, dr = sym_delta(t, setup.t_gt)
    assert dt < 6e-3 and dr < 0.5


# --- tests ---------------------------------------------------------------------------


def test_world_of_one_mesh_equals_single_device(setup, words, single, tmp_path):
    """A (1, 1) mesh in a world of one rank (no collective at all) repeats the
    single-device round: integer outputs equal, poses within tolerance.  A
    world smaller than a mesh raises, as a 'cuda' mesh without a card does."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        model, prep = _port_inputs({"model": setup.model, "scene": setup.scene})
        mpack = tsk.pack_model_cached(model, coarse_points=TPOLICY.coarse_model_points,
                                      fine_points=TPOLICY.fine_model_points)
        zeros = torch.zeros(prep.cloud.capacity, dtype=torch.bool)
        got = _numpy(*p2d.search_round_2d_prep(
            p2d.make_mesh_2d(1, 1, device_type="cpu"), model, prep, zeros, zeros.clone(),
            _draws(words), 3.0, 0.5, mpack, policy=TPOLICY, **ROUND))
        _same_round(got, single)
        assert got["accept"].any()
        with pytest.raises(ValueError, match="need 2 ranks"):
            p2d.make_mesh_2d(1, 2, device_type="cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA card"):
                pmesh.make_mesh(1)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match="need 2 ranks"):
        pmesh.make_mesh(2, device_type="cpu")


def test_sp_mesh_matches_jax_and_single_device(setup, jax_rounds, single, two_ranks):
    """(1, 2): the JAX package's sharded round, and the port's single device
    (one chunk: the same draws), in samples, counts, accepts and claims."""
    ranks, _ = two_ranks
    got = ranks[0]["12"]
    _same_round(got, single)
    _same_round(got, jax_rounds[(1, 2)])
    _found(setup, got)
    for r in ranks[1:]:
        _same_round(r["12"], got)


def test_dp_meshes_agree(setup, single, two_ranks):
    """The 1-axis (2,) mesh and the (2, 1) mesh: two chunks with the same
    draws give the same finalists and accept decisions; chunk 0's firsts are
    the single device's, and both chunks' hypotheses count."""
    ranks, _ = two_ranks
    a, b = ranks[0]["2"], ranks[0]["21"]
    _same_round(a, b)
    assert (a["fp"] >= single["fp"]).all() and a["fp"].sum() > single["fp"].sum()
    assert single["hypotheses"] < a["hypotheses"] <= 2 * single["hypotheses"] + 1
    _found(setup, a)
    for r in ranks[1:]:
        _same_round(r["2"], a)
        _same_round(r["21"], b)


def test_mesh_prepare_scene_and_finish_find_sp(setup, two_ranks):
    """The mesh scene preparation gives the single device's tangent mask; the
    sharded finish_find its counts, score and correspondences."""
    ranks, t = two_ranks
    model, prep = _port_inputs({"model": setup.model, "scene": setup.scene})
    single = td.prepare_scene(prep.cloud, TPOLICY, grid_threshold=0)
    for r in ranks:
        np.testing.assert_array_equal(r["prep_mask"], single.tangent_mask.numpy())
    assert single.tangent_mask.sum() > 0
    ref = tscore.finish_find(model, prep.cloud, prep.tangent_mask,
                             torch.zeros(prep.cloud.capacity, dtype=torch.bool),
                             torch.from_numpy(t), 3.0)
    for r in ranks:
        ff = r["ff"]
        assert ff["count"] == int(ref.count) > 0
        np.testing.assert_allclose(ff["score"], float(ref.score), rtol=1e-5)
        np.testing.assert_array_equal(ff["valid"], ref.valid.numpy())
        v = ref.valid.numpy()
        np.testing.assert_array_equal(ff["model_idx"][v], ref.model_idx.numpy()[v])


def test_dp_sp_meshes_on_four_ranks(setup, jax_rounds, four_ranks):
    """(2, 2) against the JAX package's (2, 2) round; with the fog route's
    join, (2, 2) and (2, 1, 2) give every rank the same result, each other's,
    and find the planted instance."""
    _same_round(four_ranks[0]["22"], jax_rounds[(2, 2)])
    for name in ("22fog", "212fog"):
        got = four_ranks[0][name]
        assert got["accept"].shape == (2,)  # the prescreen cut
        _found(setup, got)
        for r in four_ranks[1:]:
            _same_round(r[name], got)
    # two chunks either way (dp 2, or dcn 2 x dp 1) with the same draws: the
    # hierarchical join picks the same finalists
    _same_round(four_ranks[0]["212fog"], four_ranks[0]["22fog"])


@pytest.mark.parametrize("sp", [1, 2, 3, 8])
def test_bucket_capacity_equals_jax(sp):
    """Aligned to the sp extent and idempotent, as JAX's (conftest's virtual
    devices give JAX its mesh; the port's function reads only the extent)."""
    from triplet_match_tpu import api as japi
    from triplet_match_tpu.parallel.search2d import make_mesh_2d

    jmesh = make_mesh_2d(1, sp)
    tmesh = SimpleNamespace(mesh_dim_names=("dp", "sp"), size=lambda i: (1, sp)[i])
    for min_cap in (1, 1000, 4096):
        for n in (1, 999, 1000, 1025, 4097, 65536, 131071, 500000):
            got = api._bucket_capacity(n, min_cap, tmesh)
            assert got == japi._bucket_capacity(n, min_cap, jmesh)
            assert got % sp == 0 and api._bucket_capacity(got, min_cap, tmesh) == got


def test_cli_host_devices(setup, tmp_path, monkeypatch):
    """``--host-devices 2 --sp 2 --cpu``: two spawned ranks, exit 0, rank 0's
    transform the single-rank CLI's (one chunk: the same search)."""
    import json

    from triplet_match_tpu_torch.io.pcd import write_pcd

    policy = dataclasses.replace(TPOLICY, adaptive_second_samples=False)
    monkeypatch.setattr(cli, "POLICY", policy)
    paths = {k: str(tmp_path / f"{k}.pcd") for k in ("model", "scene")}
    write_pcd(paths["model"], setup.xyz, setup.nrm, setup.tan)
    s = setup.raw_scene
    write_pcd(paths["scene"], *(np.asarray(getattr(s, f)) for f in ("xyz", "normal", "tangent")))
    flags = ["--cpu", "--quiet", "--model-match-factor", "0.5", "--max-icp", "5"]
    one, two = str(tmp_path / "one.json"), str(tmp_path / "two.json")
    assert cli.main([paths["model"], paths["scene"], *flags, "--out", one]) == 0
    assert cli.main([paths["model"], paths["scene"], *flags, "--out", two, "--host-devices",
                     "2", "--sp", "2"]) == 0
    t1, t2 = (np.asarray(json.loads(open(p).read())["matches"][0]["transform"]) for p in (one, two))
    dt, dr = pose_delta(torch.from_numpy(t1), torch.from_numpy(t2))
    assert float(dt) < 1e-4 and float(np.degrees(float(dr))) < 0.01
