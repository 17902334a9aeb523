"""Compiled-model serialization (counterpart of ``triplet_match_tpu.index.serialize``).

The compiled model is pure arrays, so it saves to an npz with the JAX
package's field names and dtypes (int32 indices, uint32 keys): a model saved
by either package loads in the other.
"""

from __future__ import annotations

import numpy as np

from triplet_match_tpu_torch.config import DiscretizationParams
from triplet_match_tpu_torch.index.model import CompiledModel, compiled_model_from_numpy

_CLOUD_FIELDS = ("xyz", "normal", "tangent", "valid")
_MODEL_FIELDS = (
    "resolution", "diameter", "to_voxel", "lut", "edge", "bounds_min",
    "bounds_max", "keys", "pairs", "pair_count", "n_edge", "n_all",
)
# the JAX package's dtypes of the integer fields (the port holds them as int64)
_INT_DTYPES = {"lut": np.int32, "keys": np.uint32, "pairs": np.int32, "pair_count": np.int32,
               "n_edge": np.int32, "n_all": np.int32}


def save_model(path: str, model: CompiledModel,
               discretization: DiscretizationParams | None = None) -> None:
    """Save a compiled model; pass the DiscretizationParams it was compiled
    with so loads can reuse them (the pair-table keys are quantized under
    those params, and querying with others misses every bucket)."""
    data = {f"cloud_{k}": getattr(model.cloud, k).cpu().numpy() for k in _CLOUD_FIELDS}
    for k in _MODEL_FIELDS:
        a = getattr(model, k).cpu().numpy()
        data[k] = a.astype(_INT_DTYPES[k]) if k in _INT_DTYPES else a
    data["margin"] = np.int32(model.margin)
    if discretization is not None:
        data["disc_distance_step_count"] = np.int32(discretization.distance_step_count)
        data["disc_angle_step"] = np.float64(discretization.angle_step)
        data["disc_curvature_ratio_step_count"] = np.int32(
            discretization.curvature_ratio_step_count)
    # np.savez_compressed appends ".npz" to a suffix-less path; a file object
    # keeps the literal path
    with open(path, "wb") as f:
        np.savez_compressed(f, **data)


def load_model(path: str, device="cuda") -> CompiledModel:
    """Load a compiled model onto ``device`` (default the CUDA card)."""
    with np.load(path) as z:
        return compiled_model_from_numpy(z, device=device)


def load_discretization(path: str) -> DiscretizationParams | None:
    """DiscretizationParams stored with the model, or None (files saved without)."""
    with np.load(path) as z:
        if "disc_distance_step_count" not in z:
            return None
        return DiscretizationParams(
            distance_step_count=int(z["disc_distance_step_count"]),
            angle_step=float(z["disc_angle_step"]),
            curvature_ratio_step_count=int(z["disc_curvature_ratio_step_count"]),
        )
