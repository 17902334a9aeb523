"""PCD IO of the PyTorch port against the JAX package's writer and readers.

ASCII and binary files are byte-equal to the JAX writer's for the same
arrays.  For binary_compressed the port's pure-Python encoder writes literal
runs while the JAX writer compresses through its native library when that is
built, so there the files are held to reading back the same arrays in both
packages.  The streaming reader gives the one-shot reader's arrays.
"""

import numpy as np
import pytest
import torch

from triplet_match_tpu.io import pcd as jpcd
from triplet_match_tpu.io.stream import read_pcd_streaming as jread_streaming

from triplet_match_tpu_torch.io import pcd as tpcd
from triplet_match_tpu_torch.io.stream import iter_pcd_chunks, read_pcd_streaming

MODES = {"ascii": {"binary": False}, "binary": {}, "binary_compressed": {"compressed": True}}


def _arrays(n=300, seed=0):
    rng = np.random.default_rng(seed)
    xyz = rng.normal(size=(n, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tan = rng.normal(size=(n, 3)).astype(np.float32)
    xyz[7] = np.nan  # an invalid row, kept raw by the readers
    return xyz, nrm, tan


@pytest.mark.parametrize("mode", list(MODES))
def test_pcd_round_trip_and_cross_package(tmp_path, mode):
    xyz, nrm, tan = _arrays()
    ours, theirs = str(tmp_path / "t.pcd"), str(tmp_path / "j.pcd")
    tpcd.write_pcd(ours, xyz, nrm, tan, **MODES[mode])
    jpcd.write_pcd(theirs, xyz, nrm, tan, **MODES[mode])
    if mode != "binary_compressed":
        assert open(ours, "rb").read() == open(theirs, "rb").read()
    for path in (ours, theirs):
        for got, want in zip(tpcd.read_pcd_arrays(path), (xyz, nrm, tan)):
            np.testing.assert_array_equal(got, want)
        for got, want in zip(jpcd.read_pcd_arrays(path), (xyz, nrm, tan)):
            np.testing.assert_array_equal(got, want)
    cloud = tpcd.read_pcd(ours, device="cpu")
    assert cloud.capacity == xyz.shape[0] and not bool(cloud.valid[7])
    assert int(cloud.count()) == xyz.shape[0] - 1
    # the streaming reader: the same raw rows in chunks, the same cloud
    rows = np.concatenate([c[0] for c in iter_pcd_chunks(ours, chunk_points=128)])
    np.testing.assert_array_equal(rows, xyz)
    streamed = read_pcd_streaming(ours, chunk_points=100, device="cpu")
    jstreamed = jread_streaming(ours, chunk_points=100)
    for f in ("xyz", "normal", "tangent", "valid"):
        np.testing.assert_array_equal(getattr(streamed, f).numpy(), getattr(cloud, f).numpy())
        np.testing.assert_array_equal(getattr(streamed, f).numpy(),
                                      np.asarray(getattr(jstreamed, f)))


def test_lzf_decoder_reads_back_references():
    """The port's decoder against the JAX package's pure-Python one on a
    stream with back-references (hand-built: a literal run, then a long and a
    short match)."""
    stream = bytes([3]) + b"abcd" + bytes([0xE0, 3, 3]) + bytes([0x40, 3])
    out = tpcd._lzf_decompress(stream, 4 + 12 + 4).tobytes()
    assert out == jpcd._lzf_decompress_py(stream, len(out)).tobytes() == b"abcd" * 5
    data = torch.arange(1000, dtype=torch.int32).numpy().tobytes()
    assert tpcd._lzf_decompress(tpcd._lzf_compress(data), len(data)).tobytes() == data
