"""PCD file IO (counterpart of ``triplet_match_tpu.io.pcd``; numpy, no PCL).

Replaces ``pointcloud::from_pcd`` (impl/pointcloud.hpp:58-64).  Reads and
writes ASCII, binary and binary_compressed (LZF) PCD v0.7 with the JAX
package's field layout, so a file written by either package reads the same
in the other.  Tangents are read from ``tangent_x/y/z`` fields when present,
falling back to the reference's ``PointSurfel.data_c[1..3]`` convention
(fields ``data_c1..data_c3``, include/common:62-70); missing fields default
to 0.

``binary_compressed`` bodies are ``u32 compressed_size, u32 decompressed
size`` followed by an LZF stream of the FIELD-MAJOR (SoA) point data, the
layout PCL writes and reads.  The LZF codec is pure Python: the decoder reads
any liblzf stream, the encoder writes a literal-only stream (valid LZF, not
compressed).  The JAX package's native shim is not loaded.
"""

from __future__ import annotations

import numpy as np

from triplet_match_tpu_torch.core.cloud import PointCloud


def _lzf_decompress(data: bytes, out_size: int) -> np.ndarray:
    """LZF decode (liblzf stream format)."""
    out = bytearray(out_size)
    i, o, n = 0, 0, len(data)
    while i < n:
        ctrl = data[i]
        i += 1
        if ctrl < 32:
            ln = ctrl + 1
            out[o:o + ln] = data[i:i + ln]
            i += ln
            o += ln
        else:
            ln = ctrl >> 5
            if ln == 7:
                ln += data[i]
                i += 1
            ln += 2
            ref = o - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            if ref < 0:
                raise ValueError("malformed LZF stream (negative back-reference)")
            for j in range(ln):  # may overlap; byte by byte
                out[o + j] = out[ref + j]
            o += ln
    if o != out_size:
        raise ValueError(f"LZF decompress produced {o} bytes, expected {out_size}")
    return np.frombuffer(bytes(out), np.uint8)


def _lzf_compress(data: bytes) -> bytes:
    """LZF encode as literal runs of up to 32 bytes (a valid stream)."""
    return b"".join(bytes([len(data[i:i + 32]) - 1]) + data[i:i + 32]
                    for i in range(0, len(data), 32))


_TYPE_MAP = {("F", 4): "<f4", ("F", 8): "<f8", ("I", 1): "<i1", ("I", 2): "<i2",
             ("I", 4): "<i4", ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4"}


def _parse_header(data: bytes):
    header = {}
    offset = 0
    while True:
        nl = data.index(b"\n", offset)
        line = data[offset:nl].decode("ascii", "replace").strip()
        offset = nl + 1
        if not line or line.startswith("#"):
            continue
        key, _, rest = line.partition(" ")
        header[key.upper()] = rest.split()
        if key.upper() == "DATA":
            break
    return header, offset


def _field_layout(header) -> tuple[np.dtype, list[str]]:
    """Structured record dtype and flat column names from a PCD header,
    shared by the one-shot reader and the streaming reader (io/stream.py)."""
    fields = header["FIELDS"]
    sizes = [int(s) for s in header["SIZE"]]
    types = header["TYPE"]
    counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
    dtype_fields, names = [], []
    for fld, sz, ty, ct in zip(fields, sizes, types, counts):
        base = _TYPE_MAP[(ty, sz)]
        for c in range(ct):
            name = fld if ct == 1 else f"{fld}_{c}"
            names.append(name)
            dtype_fields.append((name, base))
    return np.dtype(dtype_fields), names


# candidate column names per output channel: PCL normals, and the
# reference's tangent convention PointSurfel.data_c[1..3] (include/common:62-70)
_COLS = {
    "x": ("x",), "y": ("y",), "z": ("z",),
    "nx": ("normal_x", "nx"), "ny": ("normal_y", "ny"), "nz": ("normal_z", "nz"),
    "tx": ("tangent_x", "data_c_1", "data_c1"),
    "ty": ("tangent_y", "data_c_2", "data_c2"),
    "tz": ("tangent_z", "data_c_3", "data_c3"),
}


def _extract_columns(arr, names) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(xyz, normal, tangent) float32 from a structured record array; absent
    channels come back zero-filled.  Shared with io/stream.py."""
    def col(cands):
        for c in cands:
            if c in names:
                return np.asarray(arr[c], np.float32)
        return np.zeros(len(arr), np.float32)

    xyz = np.stack([col(_COLS["x"]), col(_COLS["y"]), col(_COLS["z"])], 1)
    nrm = np.stack([col(_COLS["nx"]), col(_COLS["ny"]), col(_COLS["nz"])], 1)
    tan = np.stack([col(_COLS["tx"]), col(_COLS["ty"]), col(_COLS["tz"])], 1)
    return xyz, nrm, tan


def read_pcd_arrays(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode a PCD into raw (xyz, normal, tangent) float32 arrays.

    Rows are returned verbatim: NaN/inf values are kept (PCL writes NaN rows
    for invalid points) and sanitized by ``PointCloud.from_arrays``.  The
    streaming reader chunks these raw rows, so a NaN point mid-array cannot
    shift later points across chunk boundaries.
    """
    with open(path, "rb") as f:
        data = f.read()
    header, offset = _parse_header(data)
    n = int(header["POINTS"][0])
    mode = header["DATA"][0].lower()
    dt, names = _field_layout(header)

    if mode == "binary":
        arr = np.frombuffer(data, dtype=dt, count=n, offset=offset)
    elif mode == "binary_compressed":
        comp_size, raw_size = np.frombuffer(data, "<u4", count=2, offset=offset)
        raw = _lzf_decompress(data[offset + 8:offset + 8 + int(comp_size)], int(raw_size))
        arr = np.zeros(n, dtype=dt)  # field-major (SoA): all values of field 0, then 1, ...
        pos = 0
        for name in names:
            fw = dt[name].itemsize
            arr[name] = raw[pos:pos + n * fw].view(dt[name].newbyteorder("<"))
            pos += n * fw
    elif mode == "ascii":
        text = data[offset:].decode("ascii", "replace")
        flat = np.loadtxt(text.splitlines(), dtype=np.float64, ndmin=2)
        arr = np.zeros(n, dtype=dt)
        for i, name in enumerate(names):
            arr[name] = flat[:n, i].astype(dt[name])
    else:
        raise ValueError(f"unsupported PCD DATA mode: {mode}")
    return _extract_columns(arr, names)


def read_pcd(path: str, capacity: int | None = None, device="cuda") -> PointCloud:
    """Read a PCD into a ``PointCloud`` on ``device`` (default the CUDA card)."""
    xyz, normal, tangent = read_pcd_arrays(path)
    return PointCloud.from_arrays(xyz, normal, tangent, capacity=capacity, device=device)


def write_pcd(path: str, xyz, normal=None, tangent=None, *, binary: bool = True,
              compressed: bool = False):
    """Write float32 x y z normal_* tangent_* fields as ascii, binary or
    binary_compressed PCD v0.7 (the JAX writer's header and layout)."""
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    normal = np.zeros_like(xyz) if normal is None else np.asarray(normal, np.float32)
    tangent = np.zeros_like(xyz) if tangent is None else np.asarray(tangent, np.float32)
    mode = "binary_compressed" if compressed else ("binary" if binary else "ascii")
    fields = "x y z normal_x normal_y normal_z tangent_x tangent_y tangent_z"
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        f"FIELDS {fields}\nSIZE 4 4 4 4 4 4 4 4 4\nTYPE F F F F F F F F F\n"
        f"COUNT 1 1 1 1 1 1 1 1 1\nWIDTH {n}\nHEIGHT 1\n"
        f"VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\nDATA {mode}\n"
    )
    body = np.concatenate([xyz, normal, tangent], axis=1).astype("<f4")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if compressed:
            raw = np.ascontiguousarray(body.T).tobytes()  # field-major (SoA) like PCL
            comp = _lzf_compress(raw)
            f.write(np.asarray([len(comp), len(raw)], "<u4").tobytes())
            f.write(comp)
        elif binary:
            f.write(body.tobytes())
        else:
            np.savetxt(f, body, fmt="%.9g")
