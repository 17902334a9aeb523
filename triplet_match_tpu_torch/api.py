"""Public object API (counterpart of ``triplet_match_tpu.api``), mirroring the
reference's ``model`` / ``scene`` classes (include/model:31-61,
include/scene:36-53):

    m = Model(cloud, DiscretizationParams(...))
    m.init(SampleParams(...))                    # model::init
    s = Scene(scene_cloud)
    matches = s.find_all_parallel(m, dist_thres, model_match_factor,
                                  early_out_factor, sample_params, max_icp)
    inst = s.instantiate(m, matches[0])

``Matcher`` serves a stream of scenes against one model, ``MultiMatcher``
against a model library.  Everything runs on the device of the model's
cloud (the CUDA card unless the caller built it on the CPU).  Differences
from the reference are the JAX package's: searches are deterministic under
``seed``, ``pair_count()`` returns the real count, ``instantiate`` places
every model point by default, and ``statistics`` is populated.  ``mesh=``
takes a ``torch.distributed`` ``DeviceMesh`` over every rank (see
``parallel/``), each rank a process making the same calls.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from triplet_match_tpu_torch.config import (
    DEFAULT_DISCRETIZATION,
    DEFAULT_POLICY,
    DEFAULT_SAMPLE_PARAMS,
    DiscretizationParams,
    SampleParams,
    SearchPolicy,
)
from triplet_match_tpu_torch.core.cloud import PointCloud, pad_capacity
from triplet_match_tpu_torch.core.transforms import strict_fp32
from triplet_match_tpu_torch.index import model as model_index
from triplet_match_tpu_torch.index.serialize import load_discretization, load_model, save_model
from triplet_match_tpu_torch.parallel.mesh import check_mesh
from triplet_match_tpu_torch.search import driver

@dataclasses.dataclass
class Statistics:
    """Populated search statistics (include/scene:31-33, never filled there)."""

    rejection_rate: float = 0.0
    rounds: int = 0
    hypotheses_scored: int = 0
    matches_accepted: int = 0


class Model:
    """``model<Point>`` analog (include/model:31-61)."""

    def __init__(self, cloud: PointCloud, params: DiscretizationParams = DEFAULT_DISCRETIZATION,
                 policy: SearchPolicy = DEFAULT_POLICY):
        self._cloud = cloud
        self._params = params
        self._policy = policy
        self._compiled: model_index.CompiledModel | None = None

    def init(self, sample_params: SampleParams = DEFAULT_SAMPLE_PARAMS,
             subset: np.ndarray | None = None) -> "Model":
        """``model::init`` (include/model:35-37).  The subset restricts only the
        edge/pair-table eligibility; the voxel LUT and scoring keep the whole
        cloud (impl/model.hpp:17-30).  Under ``SearchPolicy.resolve_symmetry``
        it also detects the model's self-symmetry orbit, which the join then
        resolves each match on."""
        mask = None
        if subset is not None:
            mask = np.zeros(self._cloud.capacity, bool)
            mask[np.asarray(subset)] = True
        compiled = model_index.compile_model(self._cloud, self._params, sample_params,
                                             self._policy, subset=mask)
        if self._policy.resolve_symmetry:
            from triplet_match_tpu_torch.index.symmetry import (close_orbit,
                                                                detect_self_symmetries)

            with torch.profiler.record_function("model.orbit"):
                orbit = close_orbit(compiled, detect_self_symmetries(
                    compiled, self._params, sample_params, self._policy), self._policy)
            compiled = dataclasses.replace(
                compiled, orbit=torch.as_tensor(orbit, device=compiled.cloud.device))
        self._compiled = compiled
        return self

    @property
    def compiled(self) -> model_index.CompiledModel:
        if self._compiled is None:
            raise RuntimeError("Cannot query uninitialized model")  # impl/model.hpp:172
        return self._compiled

    @property
    def device(self) -> torch.device:
        return self.compiled.cloud.device

    def query(self, feature, cap: int | None = None) -> np.ndarray:
        """``model::query`` (impl/model.hpp:169-178): the (i, j) pairs of a
        4-D feature, [n, 2] int64."""
        cap = cap or self._policy.query_cap
        f = torch.tensor(np.asarray(feature, np.float32), device=self.device)
        pairs, valid = model_index.query_pairs(self.compiled, f[None, :], self._params, cap,
                                               limit=self._policy.query_limit)
        return pairs[0][valid[0]].cpu().numpy()

    def voxel_query(self, pos) -> int | None:
        """``model::voxel_query`` (impl/model.hpp:180-192): index or None."""
        p = torch.tensor(np.asarray(pos, np.float32), device=self.device)
        idx, ok = model_index.voxel_query(self.compiled, p[None, :])
        return int(idx[0]) if bool(ok[0]) else None

    def diameter(self) -> float:
        return float(self.compiled.diameter)

    def resolution(self) -> float:
        return float(self.compiled.resolution)

    def point_count(self) -> int:
        return int(self.compiled.n_edge)  # subset size, model:point_count semantics

    def pair_count(self) -> int:
        return int(self.compiled.pair_count)

    def extents(self) -> tuple[int, int, int]:
        return self.compiled.extents

    def voxel_transform(self) -> np.ndarray:
        return self.compiled.to_voxel.cpu().numpy()

    def margin(self) -> int:
        return self.compiled.margin

    def feature_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        return self.compiled.bounds_min.cpu().numpy(), self.compiled.bounds_max.cpu().numpy()

    def cloud(self) -> PointCloud:
        return self._cloud

    def save(self, path: str):
        save_model(path, self.compiled, self._params)

    @staticmethod
    def load(path: str, params: DiscretizationParams = DEFAULT_DISCRETIZATION,
             policy: SearchPolicy = DEFAULT_POLICY, device="cuda") -> "Model":
        """Load a saved model onto ``device``.  The DiscretizationParams stored
        with it win over ``params``: its pair-table keys are quantized under
        them, and querying with others misses every bucket."""
        stored = load_discretization(path)
        if stored is not None and stored != params:
            if params != DEFAULT_DISCRETIZATION:
                warnings.warn(f"{path} was compiled with {stored}; ignoring the mismatched "
                              "DiscretizationParams passed to load()", stacklevel=2)
            params = stored
        m = Model.__new__(Model)
        m._params = params
        m._policy = policy
        m._compiled = load_model(path, device=device)
        m._cloud = m._compiled.cloud
        return m


class Scene:
    """``scene<Point>`` analog (include/scene:36-53)."""

    def __init__(self, cloud: PointCloud, policy: SearchPolicy = DEFAULT_POLICY):
        self._cloud = cloud
        self._policy = policy
        self._prep = None
        self._prep_mesh = None
        self.statistics = Statistics()

    def _prepare(self, device: torch.device, mesh=None) -> driver.ScenePrep:
        """The scene preparation on the model's device (under ``mesh``), made
        once per device and mesh."""
        if (self._prep is None or self._prep.cloud.device != device
                or self._prep_mesh is not mesh):
            with strict_fp32():
                self._prep = driver.prepare_scene(self._cloud.to(device), self._policy,
                                                  mesh=mesh)
            self._prep_mesh = mesh
        return self._prep

    def find_all_parallel(self, model: Model, dist_thres: float = 3.0,
                          model_match_factor: float = 0.4, early_out_factor: float = 0.9,
                          sample_params: SampleParams = DEFAULT_SAMPLE_PARAMS,
                          max_icp_iterations: int = 10, seed: int = 13, mesh=None,
                          progress=None) -> list[driver.Match]:
        """``scene::find_all_parallel`` (include/scene:47-48) on the model's
        device.  ``mesh``: a ``DeviceMesh`` over every rank, 1-axis for
        hypothesis data parallelism, ("dp", "sp") to shard the scene as well
        (see ``driver.find_all``).  ``progress``: optional per-round callback
        with the fraction of the current phase done
        (``utils.progress.ProgressBar(...).poll``)."""
        matches = driver.find_all(
            model.compiled, self._cloud, dist_thres=dist_thres,
            model_match_factor=model_match_factor, early_out_factor=early_out_factor,
            sample_params=sample_params, discretization=model._params, policy=self._policy,
            max_icp_iterations=max_icp_iterations, seed=seed,
            prep=self._prepare(model.device, mesh), mesh=mesh, progress=progress)
        st = driver.LAST_SEARCH_STATS
        self.statistics = Statistics(rejection_rate=st.get("rejection_rate", 0.0),
                                     rounds=st.get("rounds", 0),
                                     hypotheses_scored=st.get("hypotheses_scored", 0),
                                     matches_accepted=len(matches))
        return matches

    def find(self, model: Model, **kwargs) -> driver.Match | None:
        """Best single match or None (the reference's single-shot ``find``,
        commented out upstream at include/scene:606-610)."""
        matches = self.find_all_parallel(model, **kwargs)
        return matches[0] if matches else None

    def instantiate(self, model: Model, match: driver.Match,
                    instantiate_all: bool = True) -> np.ndarray:
        return driver.instantiate(model.compiled, match, instantiate_all)

    def cloud(self) -> PointCloud:
        return self._cloud


class Matcher:
    """Serving session: one compiled model, a stream of scenes.

    Every incoming cloud's capacity is padded up to a power-of-two bucket
    (floor ``min_capacity``, aligned to the mesh's sp extent), as the JAX
    package does to reuse its compiled programs; here a bucket keeps the
    search's tensor shapes, and so the caching allocator's blocks, the same
    across scenes of similar size::

        matcher = Matcher(model, policy=SearchPolicy(...))
        for cloud in scene_stream:
            matches = matcher.match(cloud)
    """

    _mesh = None

    def __init__(self, model: Model, policy: SearchPolicy = DEFAULT_POLICY, *, mesh=None,
                 min_capacity: int = 4096):
        if mesh is not None:
            check_mesh(mesh)
        self._model = model
        self._policy = policy
        self._mesh = mesh
        self._min_capacity = min_capacity
        self.statistics = Statistics()

    def bucket_capacity(self, n: int) -> int:
        """Capacity bucket for a cloud of ``n`` points (``_bucket_capacity``)."""
        return _bucket_capacity(n, self._min_capacity, self._mesh)

    def match(self, cloud: PointCloud, **kwargs) -> list[driver.Match]:
        """Search one scene of any capacity.  Keyword arguments pass through
        to :meth:`Scene.find_all_parallel` (``dist_thres``, ``seed``, ...)."""
        cloud = pad_capacity(cloud, self.bucket_capacity(cloud.capacity))
        scene = Scene(cloud, self._policy)
        matches = scene.find_all_parallel(self._model, mesh=self._mesh, **kwargs)
        self.statistics = scene.statistics
        return matches

    def warmup(self, scene_sizes, dense: bool = True, **kwargs) -> list[int]:
        """Run the production search once per bucket covering ``scene_sizes``
        before live traffic: a synthetic scene with the model planted (so each
        warm search accepts after its first rounds), and with ``dense`` a
        touching-fog one that fires the fog-density switch.  The first search
        of a process builds the kernels and the card's library handles, and
        each bucket's first search sizes the allocator's blocks.  Returns the
        bucket capacities warmed."""
        caps = sorted({self.bucket_capacity(int(s)) for s in scene_sizes})
        for cap in caps:
            self.match(_warmup_scene([self._model], cap), **kwargs)
            if dense:
                self.match(_warmup_scene([self._model], cap, dense=True), **kwargs)
        return caps


def _bucket_capacity(n: int, min_capacity: int, mesh=None) -> int:
    """Smallest serving capacity bucket >= ``n``: a power of two (floor
    ``min_capacity``) rounded up to the mesh's sp extent when it has one (the
    sharded round needs the capacity divisible by sp).  Idempotent, so a
    warmup scene built at a bucket lands in that bucket even where the sp
    alignment makes it no power of two."""
    sp = 1
    if mesh is not None and "sp" in (mesh.mesh_dim_names or ()):
        sp = mesh.size(mesh.mesh_dim_names.index("sp"))

    def align(c):
        return -(-c // sp) * sp

    p = 1 << max(int(min_capacity) - 1, 0).bit_length()
    while align(p) < n:
        p <<= 1
    return align(p)


def _warmup_scene(models: list[Model], capacity: int, dense: bool = False) -> PointCloud:
    """Synthetic warmup scene of exactly ``capacity`` points on the first
    model's device: one instance of every model planted (spread along x) in
    clutter — uniform clutter with random normals, or with ``dense`` touching
    fog patches around the instances."""
    from triplet_match_tpu_torch.io.synthetic import fog_patches

    parts = []
    offset = 0.0
    for m in models:
        mc = m.compiled.cloud
        mv = mc.valid.cpu().numpy()
        d = float(m.compiled.diameter)
        shift = np.array([offset + d, 0.0, 0.0], np.float32)
        parts.append((mc.xyz.cpu().numpy()[mv] + shift, mc.normal.cpu().numpy()[mv],
                      mc.tangent.cpu().numpy()[mv]))
        offset += 2.5 * d
    xyz, nrm, tan = (np.concatenate([p[i] for p in parts]) for i in range(3))
    n_clutter = max(int(capacity) - xyz.shape[0], 0)
    rng = np.random.default_rng(0)
    d0 = float(models[0].compiled.diameter)
    if dense:
        c_xyz, c_nrm = fog_patches(rng, n_clutter, seed_base=77, size=(d0, d0),
                                   extent=max(0.8 * offset, 1.2 * d0))
    else:
        ext = max(2.0 * offset, 4.0 * d0)
        c_xyz = rng.uniform(-ext, ext, (n_clutter, 3)).astype(np.float32)
        c_nrm = rng.normal(size=(n_clutter, 3)).astype(np.float32)
        c_nrm /= np.maximum(np.linalg.norm(c_nrm, axis=1, keepdims=True), 1e-9)
    return PointCloud.from_arrays(np.concatenate([xyz, c_xyz])[:capacity],
                                  np.concatenate([nrm, c_nrm])[:capacity],
                                  np.concatenate([tan, np.zeros_like(c_xyz)])[:capacity],
                                  device=models[0].device)


class MultiMatcher:
    """Serving session over a model library: several models, a stream of
    scenes (BASELINE config 5's deployment shape)::

        mm = MultiMatcher([model_a, model_b], policy=SearchPolicy(...))
        for cloud in scene_stream:
            per_model = mm.match(cloud)       # one match list per model

    Each scene is prepared once on the first model's device and shared by
    every model (``driver.find_all_multi``); a scene point claimed by one
    model's match is unavailable to the rest.  Capacities are bucketed as in
    :class:`Matcher`.  With ``raycast_origins`` each match is raycast-verified
    and ``min_cast_score`` drops the weaker ones.  ``mesh``: as in
    :class:`Matcher`, for the scene preparation and every model's search.
    """

    def __init__(self, models: list[Model], policy: SearchPolicy = DEFAULT_POLICY, *,
                 mesh=None, min_capacity: int = 4096, raycast_origins=None,
                 min_cast_score: float | None = None):
        if mesh is not None:
            check_mesh(mesh)
        if not models:
            raise ValueError("MultiMatcher needs at least one model")
        # find_all quantizes its query features under one set of params, which
        # must be each model's compile-time set or every pair-table lookup misses
        if any(m._params != models[0]._params for m in models[1:]):
            raise ValueError("MultiMatcher models must share DiscretizationParams (got "
                             f"{[m._params for m in models]}); compile them with one params set "
                             "or serve them from separate Matchers")
        self._models = list(models)
        self._policy = policy
        self._mesh = mesh
        self._min_capacity = min_capacity
        self._raycast_origins = raycast_origins
        self._min_cast_score = min_cast_score
        self.statistics = Statistics()

    def bucket_capacity(self, n: int) -> int:
        return _bucket_capacity(n, self._min_capacity, self._mesh)

    def match(self, cloud: PointCloud, **kwargs) -> list[list[driver.Match]]:
        """Search one scene with every model; one match list per model.
        Keyword arguments pass through to ``driver.find_all`` (``dist_thres``,
        ``model_match_factor``, ``seed``, ...).  Per-model statistics stay in
        ``driver.LAST_MULTI_SEARCH_STATS``; ``statistics`` aggregates them."""
        cloud = pad_capacity(cloud, self.bucket_capacity(cloud.capacity))
        with strict_fp32():
            prep = driver.prepare_scene(cloud.to(self._models[0].device), self._policy,
                                        mesh=self._mesh)
        kwargs.setdefault("discretization", self._models[0]._params)
        results = driver.find_all_multi(
            [m.compiled for m in self._models], cloud, policy=self._policy, prep=prep,
            mesh=self._mesh,
            raycast_origins=self._raycast_origins, min_cast_score=self._min_cast_score,
            **kwargs)
        per_model = driver.LAST_MULTI_SEARCH_STATS
        self.statistics = Statistics(
            rejection_rate=(sum(s.get("rejection_rate", 0.0) for s in per_model)
                            / max(len(per_model), 1)),
            rounds=sum(s.get("rounds", 0) for s in per_model),
            hypotheses_scored=sum(s.get("hypotheses_scored", 0) for s in per_model),
            matches_accepted=sum(len(r) for r in results))
        return results

    def warmup(self, scene_sizes, dense: bool = True, **kwargs) -> list[int]:
        """Run the production search once per bucket covering ``scene_sizes``
        before live traffic, as :meth:`Matcher.warmup` does, with one instance
        of every library model planted in each warmup scene.  The JAX package
        also grows its round-executable cache here; the port compiles no
        per-shape programs, so it has no such cache.  Returns the bucket
        capacities warmed."""
        caps = sorted({self.bucket_capacity(int(s)) for s in scene_sizes})
        for cap in caps:
            self.match(_warmup_scene(self._models, cap), **kwargs)
            if dense:
                self.match(_warmup_scene(self._models, cap, dense=True), **kwargs)
        return caps
