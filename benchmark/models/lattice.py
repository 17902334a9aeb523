"""Model kind ``lattice``: the recall protocol's wire-frame scaffold, every
point an edge point on the axis-aligned beams of a cells x cells x cells
grid, tangents along the beam and normals radial, the grid planes spaced
geometrically when ``graded`` (``scripts/recall_study.py --model lattice``).
A frozen copy of ``triplet_match_tpu_torch.io.synthetic.make_lattice_model``
(``tests/test_bench_lattice.py`` holds it to the original bit for bit),
sized by the configuration's entry.  Plain numpy."""

import numpy as np


def make_lattice(cells: int, n_edge: int, size: float, seed: int, graded: bool):
    """(xyz, normal, tangent) float32 arrays of about ``n_edge`` points."""
    rng = np.random.default_rng(seed)
    if graded:
        u = np.geomspace(1.0, 2.0, cells + 1)
        lin = (size * (u - u[0]) / (u[-1] - u[0]) - size / 2).astype(np.float32)
    else:
        lin = np.linspace(-size / 2, size / 2, cells + 1).astype(np.float32)
    beams = [(vary, [a for a in range(3) if a != vary], fa, fb)
             for vary in range(3) for fa in lin for fb in lin]
    per_beam = max(n_edge // len(beams), 2)
    pts, tans, nrms = [], [], []
    for vary, fixed, fa, fb in beams:
        t = rng.uniform(-size / 2, size / 2, per_beam).astype(np.float32)
        p = np.zeros((per_beam, 3), np.float32)
        p[:, vary] = t
        p[:, fixed[0]] = fa
        p[:, fixed[1]] = fb
        tg = np.zeros((per_beam, 3), np.float32)
        tg[:, vary] = 1.0
        theta = rng.uniform(0, 2 * np.pi, per_beam).astype(np.float32)
        nm = np.zeros((per_beam, 3), np.float32)
        nm[:, fixed[0]] = np.cos(theta)
        nm[:, fixed[1]] = np.sin(theta)
        pts.append(p)
        tans.append(tg)
        nrms.append(nm)
    return (np.concatenate(pts).astype(np.float32), np.concatenate(nrms).astype(np.float32),
            np.concatenate(tans).astype(np.float32))


def make(spec: dict):
    """(xyz, normal, tangent) of the model."""
    return make_lattice(spec["cells"], spec["n_edge"], spec["size"], spec["seed"],
                        spec["graded"])
