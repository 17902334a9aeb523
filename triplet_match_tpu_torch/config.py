"""Configuration dataclasses of the PyTorch port.

A field-for-field copy of ``triplet_match_tpu.config``: importing that module
runs the JAX package's ``__init__``, which imports jax, and this package never
does.  ``tests/test_torch_config.py`` pins every default equal to the
reference's.  The field comments are the reference's own; the TPU-specific
knobs (pose tiles, group folds, interpret mode) are carried so that a policy
round-trips between the two packages unchanged.

The reference has three config tiers (see include/common:72-82,
include/discretize:8-12, include/impl/scene.hpp:11-29).  Here everything is a
runtime dataclass; the reference's compile-time ``detail::`` constants become
documented defaults in :class:`SearchPolicy`.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SampleParams:
    """Search sampling knobs.

    Mirrors ``triplet_match::sample_parameters``
    (include/common:72-82).  ``min/max_triplet_ratio`` and
    ``search_min/max_scale`` are vestigial in the reference live path (only
    the diameter factors, orthogonality-style tangent gate, and ``force_up``
    are read) but kept for API parity.
    """

    min_triplet_ratio: float = 0.2
    max_triplet_ratio: float = 1.0
    search_min_scale: float = 1.0
    search_max_scale: float = 1.0
    min_diameter_factor: float = 0.1
    max_diameter_factor: float = 1.0
    min_orthogonality: float = 0.01
    redundancy_factor: float = 1.0
    force_up: bool = False


@dataclasses.dataclass(frozen=True)
class DiscretizationParams:
    """Feature quantization parameters.

    Mirrors ``triplet_match::discretization_params``
    (include/discretize:8-12).  The demo app used
    ``{0.05, 10deg}`` (apps/triplet_match.cpp:17-20), i.e.
    20 distance steps and a 10-degree angle step.
    """

    distance_step_count: int = 20
    angle_step: float = math.radians(10.0)
    curvature_ratio_step_count: int = 20


@dataclasses.dataclass(frozen=True)
class SearchPolicy:
    """Search policy constants + TPU batching shape caps.

    The first block mirrors the reference's compile-time ``detail::``
    namespace (include/impl/scene.hpp:11-29).  The second
    block holds the static batch shapes that replace the reference's
    data-dependent loop bounds: on TPU every loop extent must be static, so
    dynamic counts become (capacity, mask) pairs.
    """

    # --- reference detail:: constants (impl/scene.hpp:11-29) ---
    # early_out: stop a phase's remaining rounds once an accepted match
    # reaches early_out_factor * possible_model corrs (impl/scene.hpp:330-347).
    early_out: bool = True
    deterministic: bool = True  # reference defaults to clock seeds; we are deterministic by default
    # match_probability/min_sample_count size the adaptive RANSAC outer bound
    # log(1-p)/log(1-n_model/|left|) clamped to [min_sample_count, n_scene]
    # (impl/scene.hpp:131-141) — see search.driver.adaptive_outer_bound.
    match_probability: float = 0.999
    min_sample_count: int = 10
    # corr_dist_factor: default dist_thres when find_all is called without one
    # (declared in the reference, impl/scene.hpp:16, and equal to the only
    # dist_thres anyone passes; never read elsewhere upstream either).
    corr_dist_factor: float = 3.0
    # query_limit: max candidate model pairs consumed per feature query
    # (impl/scene.hpp:19,310); buckets larger than min(query_cap, query_limit)
    # return that many entries at even-stride positions spanning the WHOLE
    # bucket (index.model.query_pairs; the oracle reads the same set).
    query_limit: int = 200
    # force_exhaustive: outer bound = n_scene regardless of probability
    # (impl/scene.hpp:139-141).
    force_exhaustive: bool = False
    # samples_on_all: all valid points are correspondence-eligible; when
    # False only tangent-bearing (edge) points count (impl/scene.hpp:534-536).
    samples_on_all: bool = True
    curvature_k: int = 30
    # early_drop: statistical abort of hopeless poses (impl/scene.hpp:492-506);
    # gates the batched analog, two-phase scoring (coarse subsample + rescore).
    early_drop: bool = True
    # weighted_distance: Gaussian distance weight exp(-d^2/(2*thres)) on every
    # correspondence (impl/scene.hpp:430,468); negative_scores: subtract the
    # weight when the nearest model point's kind mismatches (:473-475).  Both
    # reach ALL scoring paths: _score_points/finish_find, the Pallas ranking
    # epilogue (score_groups_pallas / two-phase survivor rescore), and ICP.
    weighted_distance: bool = False
    negative_scores: bool = False

    # --- edge-point classification (impl/model.hpp:96-99, impl/scene.hpp:50) ---
    tangent_norm_threshold: float = 0.7
    curvature_ratio_threshold: float = 0.2
    pair_parallel_epsilon: float = 0.01  # reject pairs with 1-|d.t| < eps

    # --- TPU batching caps (static shapes; replace dynamic loop bounds) ---
    # num_first_samples is the per-round first-point batch; the number of
    # rounds per phase is ceil(outer_bound / num_first_samples) with the
    # adaptive outer bound above, so the statistical sampling guarantee is
    # honored across rounds rather than within one.
    num_first_samples: int = 256  # RANSAC outer batch per round
    # num_second_samples is the static inner-bound cap: the reference's
    # per-first inner bound (impl/scene.hpp:276-282) evaluates to
    # ~max(min_sample_count, -log(1-p)*|ball|/n_model_all), typically
    # ~min_sample_count (=10) — below this default, so per-first effort
    # meets or exceeds the reference's.
    num_second_samples: int = 32  # second points tried per first (inner_bound analog)
    # adaptive_second_samples: in dense scenes the reference's per-first
    # inner bound -log(1-p)*|ball|/n_model_all EXCEEDS the static cap above
    # (|ball| = all scene points within the model diameter of the first,
    # impl/scene.hpp:273-282).  When on, find_all estimates the
    # 95th-percentile ball population at search start and raises the
    # effective num_second_samples (next power of two, capped at
    # max_second_samples) so the per-first effort meets the reference's in
    # every density regime, not just the typical ~min_sample_count one.
    # Static shapes make this per-search rather than per-first; the
    # high-quantile estimate covers the dense tail.
    adaptive_second_samples: bool = True
    max_second_samples: int = 256  # shape cap for the adaptive raise
    second_pool: int = 128  # edge-point kNN pool per first for second sampling
    query_cap: int = 16  # model pair candidates gathered per feature query (<= query_limit)
    score_neighbors: int = 512  # scene points scored per hypothesis (radius-search analog)
    finalists: int = 4  # hypotheses promoted to full scoring + ICP per round (best_ts analog, <=5)
    max_instances: int = 8  # multi-instance extraction cap per find_all
    # max_rounds caps TOTAL rounds across all phases — a safety valve only;
    # the reference's while(true) (impl/scene.hpp:70-95) has no cap.  Set
    # high enough that the adaptive outer bound, not this, ends the search.
    max_rounds: int = 64

    # --- scorer backend ---
    # "auto": fused Pallas kernel on TPU, jnp voxel-LUT scorer elsewhere.
    # The Pallas scorer ranks hypotheses by exact-NN correspondence count
    # (the early-out/early-drop analog); finalists are then rescored with
    # the reference-faithful finish_find either way.
    scorer: str = "auto"  # "auto" | "pallas" | "jnp"
    pallas_interpret: bool = False  # interpret-mode Pallas (tests on CPU)
    # two-phase scoring = the reference's statistical early-drop
    # (impl/scene.hpp:492-506) batched: coarse pass on a strided
    # neighborhood subsample, full rescore of the per-group top poses.
    # Defaults were validated by 10-seed touching-fog recall studies
    # (scripts/recall_study.py): stride 8 / keep 1/32 / coarse-model finds
    # 10/10 with poses identical to the conservative settings (max 0.32mm /
    # 0.05deg) and is the fastest end-to-end (7.0s vs 10.6s mean search;
    # stride 16/32 rank noisier and LOSE end-to-end despite higher kernel
    # throughput).
    two_phase_scoring: bool = True
    two_phase_stride: int = 8  # coarse-pass neighborhood subsample stride
    two_phase_keep_frac: int = 32  # rescore top 1/keep_frac poses per group
    # phase-2 neighborhood stride: > 1 rescores survivors on a subsampled
    # neighborhood too (ranking only — finalists get true finish_find
    # scores).  Default 4 cleared by recall studies: 10/10 at 131k with
    # poses identical to stride 1 (max 0.37mm/0.04deg), end-to-end search
    # 4.18s vs 5.48s mean, kernel 8.4M vs 6.2M poses/s.
    two_phase_fine_stride: int = 4
    # phase-1 additionally ranks against a coarse model subsample (distance
    # gate inflated by its coverage radius so true correspondences cannot be
    # missed); survivors are always rescored against the model.  256 reps
    # (gate 3.5x thres) measured -23% kernel time over 512 and cleared the
    # 10-seed touching-fog recall study (10/10, max 0.29mm/0.04deg) — the
    # strict-gate tiebreak term keeps the inflated gate's ranking sharp.
    two_phase_coarse_model: bool = True
    coarse_model_points: int = 256  # coarse block size (pack_model coarse_points)
    # ranking_mode: what the two-phase survivor rescore returns as the
    # hypothesis RANKING — "count" (production: correspondence counts; the
    # acceptance gates are count-based, impl/scene.hpp:227) or "full" (the
    # reference's orientation-weighted score sum(|ref.ref_n|),
    # impl/scene.hpp:469-489).  Full mode costs ~200x count mode per scored
    # pose, but the coarse phase screens ~97% of poses first, so full-mode
    # RANKING at production scale costs only the survivor fraction (the
    # VERDICT r2 #8 "count-mode phase 1, full-mode on survivors" structure).
    ranking_mode: str = "count"
    # pose-linearized coarse ranker (score_groups_coarse_linear): the 4-D
    # distance decomposes into per-point statics x per-pose model rows, so
    # the kernel is two matmuls (one at full 128-deep MXU contraction) with
    # ZERO per-pose VPU transform work — ROADMAP 3d lever b.  Same optimistic
    # no-miss contract as the direct coarse kernel.
    two_phase_coarse_linear: bool = False
    # survivor ranking against the medium 4-D block (pack_model fine_points)
    # instead of the full pack's two-block kind-competition sweep: the fine
    # phase's output is a RANKING only (finalists get true finish_find
    # scores), and its full-pack sweep is the two-phase pipeline's dominant
    # VMEM traffic.  Same slack-inflated no-miss contract at the fine
    # block's (tighter) coverage radius.  Count-mode only; ignored when
    # ranking_mode="full" or the weighted/negative knobs are on.  Default on
    # after the 10-seed touching-fog recall study (10/10, max 0.35mm/0.04deg
    # with the strict-gate tiebreak; without the tiebreak one seed drifted
    # to 5.9mm — the inflated gate blurs poses within the slack band).
    two_phase_fine_coarse: bool = True
    # medium block size (pack_model fine_points).  768 -> 512 flipped in
    # round 4 on hardware end-to-end evidence: per-seed IDENTICAL poses to
    # 768 on the 10-seed touching-fog protocol at 131k with mean search
    # 7.9 s vs 9.7 s (RESULTS_r4 r4_hw_fine512); dense scales are
    # unaffected (the fog-density switch routes them to the full-pack
    # rescore, bypassing the fine block).
    fine_model_points: int = 512
    # rank phase-2 survivors by the STRICT-gate count (the reference's own
    # ranking statistic, impl/scene.hpp:468-475) with the inflated no-miss
    # count demoted to the tiebreak.  The inflated-primary ordering blurs
    # with the fine block's coverage radius (fine blocks below 1536 reps
    # measured mm-scale pose drift in the touching-fog recall study —
    # ROADMAP 3d6); strict-primary decouples pose precision from the fine
    # block size, which is what lets fine_model_points sit at 512 (10-seed
    # touching fog on chip: 10/10, per-seed poses identical to the 768
    # block and to the exact single-phase control — RESULTS_r4
    # r4_hw_fine512/r4_hw_recall131k).  Phase 1 always keeps the inflated
    # no-miss primary (it decides drops).
    two_phase_fine_strict: bool = True
    # fog-density-adaptive EXACT routing: when the model-diameter ball
    # around first points is fog-dominated (estimated 95th-pct ball
    # population > fine_full_rescore_ratio * score_neighbors), any
    # coverage-radius-blurred block ranking (coarse phase-1 AND the
    # fine_coarse rescore) loses sub-radius pose resolution (fog fills the
    # coverage band and drowns the strict-count differences) — find_all
    # then routes to the exact two-phase configuration: FULL-pack phase 1,
    # full-pack full-K survivor rescore, keep 1/8.
    # Evidence: (r3, CPU f32 interpret, exact config-4 500k scene) the
    # fine768 block accepted a 4.04 mm pose at seed 5 while full-pack
    # rescore / exact ranking land 0.251 mm; (r4, HARDWARE 10-seed 500k
    # A/B, RESULTS_r4 r4_hw_recall500k) exact routing is faster (21.7 s
    # vs 23.8 s mean) and uniformly precise (all seeds <=0.044 mm vs one
    # 0.99 mm outlier with coarse-block phase 1).  At 131k (ratio ~11.5)
    # the block ranking passes the 10-seed protocol with per-seed poses
    # identical to the exact control — the ratio threshold separates the
    # regimes with margin (500k measures ~25, 1M ~43).
    adaptive_fine_rescore: bool = True
    fine_full_rescore_ratio: float = 16.0
    # finalist funnel width when the fog switch fires: a fog-dominated
    # scene ranks ~1M hypotheses whose count margins are fog noise, so the
    # true pose only needs to CRACK the finalist set (acceptance re-gates
    # with exact full-scene counts) — the default 4-finalist funnel
    # measured 1 round x 4 fog finalists x 0 accepts on a 4M seed
    # (evidence_r4/prof4m.log).  Kept a knob: the finalist ICP join cost
    # scales linearly with this at scene-sized finish_find passes.
    adaptive_finalists: int = 16
    # width the widened funnel is cut back to (by ONE exact full-scene
    # relaxed-count pass per finalist at the unrefined pose) before the
    # full relaxed-ICP join.  The exact count is the acceptance statistic
    # itself, so ranking by it is strictly sharper than the pack-based
    # rescore that admitted the fog finalists — and one finish_find pass
    # costs ~1/(icp_iters+1) of a finalist's ICP, so the widened funnel
    # stops scaling the join linearly.  0 = screen everything with full
    # ICP (pre-round-4 behavior).  Only consulted when the fog switch
    # raises the funnel (find_all sets it to the base ``finalists``).
    finalist_prescreen: int = 0
    # rank hypotheses on EDGE-eligible scene points only (the
    # samples_on_all=False eligibility, scoped to the RANKING pack and the
    # finalist prescreen; ICP / finish_find / acceptance semantics are
    # untouched).  Acceptance requires score_t >= match_factor * n_edge
    # tangent-bearing correspondences (impl/scene.hpp:193-237) and fog has
    # no tangents — so in a fog-dominated scene, poses embedded in dense
    # fog out-COUNT the true pose at the strict band (4M seed-2: the true
    # pose cracks neither a 16- nor a 32-wide funnel,
    # evidence_r4/diag4m_s2_*.jsonl) while being unacceptable by
    # construction.  Ranking by the acceptance statistic (edge corrs) makes
    # fog poses score 0.  None = auto: the fog-density switch enables it
    # when the model has edge points; explicit True/False wins.
    rank_edges_only: bool | None = None
    # candidate-subset join: run the finalist prescreen / relaxed ICP /
    # tight polish / claim passes over a per-finalist GATHERED subset of the
    # scene instead of all N points.  A scene point can correspond to a
    # posed model only if its transformed position lands inside the voxel
    # grid — every scoring surface gates on voxel_query's in_bounds
    # (impl/model.hpp:180-192 nullopt branch) — so gathering the points
    # whose voxel coordinates fall inside the grid plus a slack border is
    # exact by construction while the pose stays within the slack
    # (candidates are regathered at each join phase boundary).  This is
    # what bounds the dense-scale join: at 2-4M points the join's
    # O(funnel * N * passes) full-scene LUT gathers dominate end-to-end
    # search seconds (52 s of a 2M steady search, RESULTS_r4
    # r4_hw_scaling_t), while the in-grid candidate set is a few percent
    # of the scene.  None = auto: the fog-density switch sizes it
    # (max(65536, N/16), pow2); 0 = always full-scene passes; explicit
    # values win.  Per-finalist candidate overflow beyond the capacity is
    # reported in LAST_SEARCH_STATS["join_overflow_max"] (0 = the subset
    # passes were exact).
    join_subset_capacity: int | None = None
    # world-space candidate slack in multiples of the *relaxed* gate
    # (2 x dist_thres x resolution): covers pose motion across the ICP
    # iterations between candidate regatherings
    join_subset_slack: float = 4.0
    # poses per kernel program: per-program fixed costs (operand DMA
    # latency, epilogue) dominate below 16; 32 measured best on v5e at the
    # 256-rep coarse block (VMEM pressure caps it)
    two_phase_pose_tile: int = 32
    # whole groups folded into one coarse-kernel program (fori_loop over
    # the leading block dim) — amortizes the per-grid-step fixed cost
    # (ROADMAP 3d4/3d9); the effective fold shrinks to an SMEM-slot-budget
    # divisor of G inside the kernel wrapper.  16 x pose_tile 32 = the
    # 512-slot SMEM ceiling, measured 12.76M poses/s vs 10.7M at the old
    # effective fold of 4 (evidence_r4/sweepgb.log; pure regrouping —
    # counts are bit-identical, no recall gate needed)
    two_phase_group_block: int = 16

    # hybrid point-to-plane Gauss-Newton in the tight ICP polish (surface
    # corrs constrained along normals, edge corrs perpendicular to tangents)
    # — an optional strictly-better refinement than the reference's
    # point-to-point umeyama; most useful on smooth / partially-observed
    # geometry where point-to-point slides tangentially
    icp_point_to_plane: bool = False

    # tight-polish (strict-gate) Kabsch iterations after the relaxed ICP.
    # The relaxed loop's 2x gate admits crossing clutter sheets whose
    # asymmetric in-gate band biases the fit by ~10 mm; each tight
    # iteration roughly halves the residual bias until the in-gate floor
    # (CPU study, tests/test_icp_clutter.py: 1-sheet bias 10.3 mm relaxed
    # -> 4.2 / 1.8 / 0.88 / 0.57 / 0.48 mm at 1/2/3/4/6 iterations).
    # 2 (the round-2 value) under-converges on dense scenes where several
    # sheets cross the instance (config 4 at 500k measured 5-9 mm).
    tight_icp_iterations: int = 6
    # weight tight-polish correspondences by |scene_dir . model_dir|
    # (the scorer's own orientation term, impl/scene.hpp:430): crossing
    # sheets meet the surface at an angle, so their corrs are downweighted
    # by the dihedral cosine; true corrs (aligned dirs) keep ~full weight
    tight_orientation_weight: bool = True
    # per-iteration threshold factor for the tight polish: iteration i runs
    # at dist_thres * max(anneal**i, 1/16).  In dense touching fog both the
    # in-band clutter count and its mean offset scale with the band width,
    # so pose bias falls ~quadratically as the band tightens while true
    # corrs (residual ~ scene noise) survive; 1.0 = legacy fixed band.
    # 0.5 default: strictly better in dense touching fog (the 4M-scale
    # 7.9 mm regression, tests/test_icp_clutter.py dense-fog study) and
    # measured harmless on clean scenes; acceptance decisions are made at
    # the UN-polished pose, so this knob can only move reported transforms
    tight_anneal: float = 0.5
    # fit the tight polish on tangent-bearing (edge) correspondences only.
    # Touching fog carries no tangents, so an edge-gated fit cannot be
    # pulled by it at ANY band width — the all-point annealed polish still
    # landed 6.3 mm / 2.6 deg off at the 4M envelope edge
    # (evidence_r5/diag4m_s2_r5.jsonl) because the in-band fog mass tracks
    # the band as it tightens.  The edge corrs are the statistic acceptance
    # already gates on (score_t >= match_factor * n_edge,
    # impl/scene.hpp:193-237), so anchoring the pose to them is the same
    # trust decision the search has already made.  Each step falls back to
    # all-point weights when fewer than 12 edge corrs are in band
    # (degenerate/edge-poor geometries); acceptance decisions are made at
    # the UN-polished pose, so the knob can only move reported transforms.
    # None = auto: the fog-density switch enables it alongside
    # rank_edges_only when the model has edge points; explicit wins.
    tight_edges_only: bool | None = None
    # fit the tight steps whose annealed band has reached the 1/16 floor
    # with the hybrid Gauss-Newton (perpendicular-to-tangent for edge
    # corrs, point-to-plane for the all-point fallback) instead of
    # point-to-point Kabsch.  Edge correspondences are nearest SAMPLES of
    # the model's edge curves, so the point-to-point fit carries the
    # along-edge sampling phase and, worse, the full along-edge error of
    # any mis-associated neighbor sample; projecting residuals onto the
    # plane perpendicular to the model tangent removes that axis from the
    # normal equations entirely.  Floor-gated (not every step): at wide
    # bands a corner point can associate to the PERPENDICULAR edge and
    # donate a wrong constraint plane, so wide-band steps stay
    # point-to-point — the floor-gated schedule measures identical
    # precision to GN-every-step on every CPU study seed
    # (scripts/study_p2l_polish.py, independently-sampled instances =
    # the realistic no-shared-sampling case: worst 2.94 -> 0.27 mm in
    # fogbound, 0.44 -> 0.27 mm clean, uniformly better on every seed).
    # None = auto: enabled with the fog-density switch alongside
    # tight_edges_only; explicit wins.  Acceptance decisions are made at
    # the UN-polished pose, so the knob can only move reported
    # transforms.  Inert at tight_anneal=1.0 (band never reaches floor).
    tight_point_to_line: bool | None = None
    # in the fog regime, take the scene's edge identity (sampling
    # eligibility, scoring kinds, edge-ranking and the acceptance
    # statistic) from the RAW provided tangents instead of the
    # curvature-gated detection mask.  Acceptance needs
    # score_t >= model_match_factor * model n_edge tangent-bearing
    # corrs, but dense fog contaminates exactly the neighborhoods the
    # curvature gate inspects — detected survivors fall with density
    # (343/600 at the 60k CPU fixture, below the 300-corr acceptance
    # threshold at the 6M envelope edge: rejection_rate 1.0, found 0 —
    # evidence_r5/diag6m_s2_r5) while the dataset's own tangent claim is
    # density-independent.  The detection mask is always a SUBSET of the
    # raw mask (the curvature pass only filters tangent-bearing points),
    # so this can only widen the statistic toward the input data's
    # labels.  None = auto with the fog switch; explicit wins.  Scenes
    # without provided tangents are unaffected (both masks empty).
    scene_raw_tangents: bool | None = None


DEFAULT_SAMPLE_PARAMS = SampleParams()
DEFAULT_DISCRETIZATION = DiscretizationParams()
DEFAULT_POLICY = SearchPolicy()
