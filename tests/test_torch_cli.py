"""The port's CLI (``tm-match-torch``), run in-process on the CPU.

Exit 0 with a parseable JSON result whose pose lies within the contract (and
a Chrome trace under ``--profile-dir``), again from the saved ``.npz`` with
the same transform; exit 2 when the scene
holds no instance; exit 1 when the mesh flags ask for more ranks than run.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from triplet_match_tpu_torch import config as tcfg
from triplet_match_tpu_torch.cli import match as cli
from triplet_match_tpu_torch.io.pcd import write_pcd
from triplet_match_tpu_torch.io.synthetic import embed_in_scene, make_box_model, sym_delta

torch.set_num_threads(2)

# a small search (the CLI, like tm-match, has no policy flags)
POLICY = dataclasses.replace(tcfg.SearchPolicy(), num_first_samples=16, num_second_samples=8,
                             query_cap=8, score_neighbors=256, finalists=2, max_rounds=2,
                             adaptive_second_samples=False)
FLAGS = ["--cpu", "--quiet", "--model-match-factor", "0.5", "--max-icp", "5"]


@pytest.fixture()
def files(tmp_path, monkeypatch):
    monkeypatch.setattr(cli, "POLICY", POLICY)
    xyz, nrm, tan = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    scene, t_gt, _ = embed_in_scene(xyz, nrm, tan, noise=0.001, n_clutter=200, seed=7,
                                    device="cpu")
    paths = {k: str(tmp_path / f"{k}.pcd") for k in ("model", "scene", "fog")}
    write_pcd(paths["model"], xyz, nrm, tan)
    write_pcd(paths["scene"], *(getattr(scene, f).numpy() for f in ("xyz", "normal", "tangent")))
    fog = np.random.default_rng(1).uniform(-2, 2, (600, 3)).astype(np.float32)
    write_pcd(paths["fog"], fog, np.tile([0.0, 0.0, 1.0], (600, 1)))  # no edge point at all
    return tmp_path, paths, t_gt


def test_cli_matches_then_rematches_from_saved_model(files):
    tmp_path, paths, t_gt = files
    out1, out2, npz = (str(tmp_path / n) for n in ("m1.json", "m2.json", "model.npz"))
    trace = tmp_path / "trace"
    assert cli.main([paths["model"], paths["scene"], *FLAGS, "--out", out1,
                     "--save-model", npz, "--profile-dir", str(trace)]) == 0
    assert json.loads((trace / "trace.json").read_text())["traceEvents"]
    assert cli.main([npz, paths["scene"], *FLAGS, "--out", out2]) == 0
    first, second = (json.loads(open(p).read()) for p in (out1, out2))
    t1 = np.asarray(first["matches"][0]["transform"], np.float32)
    np.testing.assert_array_equal(np.asarray(second["matches"][0]["transform"], np.float32), t1)
    dt, dr = sym_delta(t1, t_gt)
    assert dt < 6e-3 and dr < 0.6
    assert first["matches"][0]["scene_corr_count"] > 0 and first["elapsed_sec"] > 0


def test_cli_exit_codes_without_instance_and_for_meshes(files, capsys):
    _, paths, _ = files
    assert cli.main([paths["model"], paths["fog"], *FLAGS]) == 2
    assert json.loads(capsys.readouterr().out)["matches"] == []
    for axis in ("--dp", "--sp", "--dcn"):  # two ranks asked for, one process
        assert cli.main([paths["model"], paths["scene"], *FLAGS, axis, "2"]) == 1
        assert "need 2 ranks" in capsys.readouterr().err


def test_estimate_edge_tangents_matches_jax():
    """``--estimate-tangents``: the port's tangents against the JAX
    package's on the box model's crease points (the direction up to sign: an
    eigenvector's sign is arbitrary)."""
    from triplet_match_tpu.core.cloud import PointCloud as JCloud
    from triplet_match_tpu.ops.curvature import estimate_edge_tangents as jestimate

    from triplet_match_tpu_torch.core.cloud import PointCloud
    from triplet_match_tpu_torch.ops.curvature import estimate_edge_tangents

    xyz, nrm, _ = make_box_model(n_edge=120, n_face=360, size=(1.0, 0.8, 0.6), seed=0)
    ref = np.asarray(jestimate(JCloud.from_arrays(xyz, nrm), k=30))
    got = estimate_edge_tangents(PointCloud.from_arrays(xyz, nrm, device="cpu"), k=30).numpy()
    e_ref, e_got = np.linalg.norm(ref, axis=1) > 0.5, np.linalg.norm(got, axis=1) > 0.5
    assert e_got.sum() > 20 and (e_ref == e_got).mean() > 0.97
    both = e_ref & e_got
    assert (np.abs((ref[both] * got[both]).sum(1)) > 0.99).all()
