"""Model kind ``box``: a box CAD model, edge points with tangents on its 12
edges and face points on its 6 faces (``synthetic.make_box_model``), sized
by the configuration's entry."""

from tmbench import synthetic


def make(spec: dict):
    """(xyz, normal, tangent) of the model."""
    return synthetic.make_box_model(n_edge=spec["n_edge"], n_face=spec["n_face"],
                                    size=tuple(spec["size"]), seed=spec["seed"])
