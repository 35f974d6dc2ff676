"""Minimal PLY point-cloud / mesh IO in pure numpy.

Own copy of `object_nerf_tpu/data/ply_io.py` (the same files, byte for
byte), with the binary vertex and face records written and read as arrays
instead of one `struct.pack` per row. Replaces the reference's open3d
dependency (embedding_helper.py:92, utils/util.py:102-105,
tools/extract_mesh.py): only simple vertex/face PLY round-trips are needed,
reading a scene point cloud and writing extracted meshes.

Supports ascii and binary_little_endian, float/double vertex properties,
uchar colors, and int vertex_indices face lists.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_DTYPES = {
    "float": ("f4", 4), "float32": ("f4", 4),
    "double": ("f8", 8), "float64": ("f8", 8),
    "uchar": ("u1", 1), "uint8": ("u1", 1),
    "char": ("i1", 1), "int8": ("i1", 1),
    "short": ("i2", 2), "int16": ("i2", 2),
    "ushort": ("u2", 2), "uint16": ("u2", 2),
    "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4),
}


def read_ply(path) -> dict:
    """Read a PLY file -> {"points": (N,3) f32, "colors": (N,3) f32 | None,
    "faces": (M,3) i32 | None}."""
    raw = Path(path).read_bytes()
    header_end = raw.find(b"end_header\n") + len(b"end_header\n")
    header = raw[:header_end].decode("ascii", errors="replace")
    body = raw[header_end:]

    fmt = "ascii"
    elements = []  # [(name, count, [(prop_name, dtype_str) or ("__list__", ...)])]
    cur = None
    for line in header.splitlines():
        t = line.strip().split()
        if not t:
            continue
        if t[0] == "format":
            fmt = t[1]
        elif t[0] == "element":
            cur = (t[1], int(t[2]), [])
            elements.append(cur)
        elif t[0] == "property" and cur is not None:
            if t[1] == "list":
                cur[2].append(("__list__", t[2], t[3], t[4]))
            else:
                cur[2].append((t[2], t[1]))

    out = {"points": None, "colors": None, "faces": None, "normals": None}
    offset = 0
    ascii_lines = body.decode("ascii").splitlines() if fmt == "ascii" else None
    line_idx = 0

    for name, count, props in elements:
        if name == "vertex":
            simple = [(pn, _DTYPES[pt][0]) for pn, pt in props]
            if fmt == "ascii":
                rows = [ascii_lines[line_idx + i].split() for i in range(count)]
                line_idx += count
                arr = np.array(rows, dtype=np.float64)
                data = {pn: arr[:, k] for k, (pn, _) in enumerate(simple)}
            else:
                rec = np.dtype([(pn, "<" + dt) for pn, dt in simple])
                arr = np.frombuffer(body, dtype=rec, count=count, offset=offset)
                offset += rec.itemsize * count
                data = {pn: arr[pn].astype(np.float64) for pn, _ in simple}
            out["points"] = np.stack(
                [data["x"], data["y"], data["z"]], -1
            ).astype(np.float32)
            if all(c in data for c in ("red", "green", "blue")):
                out["colors"] = (
                    np.stack([data["red"], data["green"], data["blue"]], -1) / 255.0
                ).astype(np.float32)
            if all(c in data for c in ("nx", "ny", "nz")):
                out["normals"] = np.stack(
                    [data["nx"], data["ny"], data["nz"]], -1
                ).astype(np.float32)
        elif name == "face":
            faces = []
            if fmt == "ascii":
                for i in range(count):
                    t = ascii_lines[line_idx + i].split()
                    n = int(t[0])
                    faces.append([int(v) for v in t[1 : 1 + n]])
                line_idx += count
            else:
                (_, cnt_t, idx_t, _) = props[0]
                cnt_dt, cnt_sz = _DTYPES[cnt_t]
                idx_dt, idx_sz = _DTYPES[idx_t]
                # all-triangle lists (what write_ply emits) are one record array
                tri = np.dtype([("n", "<" + cnt_dt), ("idx", "<" + idx_dt, (3,))])
                if len(body) - offset >= tri.itemsize * count:
                    rec = np.frombuffer(body, dtype=tri, count=count, offset=offset)
                    if (rec["n"] == 3).all():
                        faces = rec["idx"]
                        offset += tri.itemsize * count
                if len(faces) != count:
                    faces = []
                    for _ in range(count):
                        n = int(np.frombuffer(body, "<" + cnt_dt, count=1, offset=offset)[0])
                        offset += cnt_sz
                        idx = np.frombuffer(body, "<" + idx_dt, count=n, offset=offset)
                        offset += idx_sz * n
                        faces.append(idx.tolist())
            out["faces"] = np.array(faces, dtype=np.int32)
    return out


def write_ply(path, points: np.ndarray, colors=None, faces=None, binary=True):
    """Write points (N,3), optional colors (N,3 in [0,1]) and faces (M,3)."""
    points = np.asarray(points, np.float32)
    n = len(points)
    lines = [
        "ply",
        f"format {'binary_little_endian' if binary else 'ascii'} 1.0",
        f"element vertex {n}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if colors is not None:
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    if faces is not None:
        lines += [f"element face {len(faces)}",
                  "property list uchar int vertex_indices"]
    lines += ["end_header"]
    header = ("\n".join(lines) + "\n").encode("ascii")

    with open(path, "wb") as f:
        f.write(header)
        col_u8 = (
            np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
            if colors is not None
            else None
        )
        if binary:
            if col_u8 is None:
                f.write(points.astype("<f4").tobytes())
            else:
                rec = np.empty(n, np.dtype([("p", "<f4", (3,)), ("c", "u1", (3,))]))
                rec["p"], rec["c"] = points, col_u8
                f.write(rec.tobytes())
            if faces is not None:
                rec = np.empty(len(faces), np.dtype([("n", "u1"), ("idx", "<i4", (3,))]))
                rec["n"], rec["idx"] = 3, np.asarray(faces, np.int32).reshape(-1, 3)
                f.write(rec.tobytes())
        else:
            for i in range(n):
                row = f"{points[i,0]} {points[i,1]} {points[i,2]}"
                if col_u8 is not None:
                    row += f" {col_u8[i,0]} {col_u8[i,1]} {col_u8[i,2]}"
                f.write((row + "\n").encode())
            if faces is not None:
                for face in np.asarray(faces, np.int32):
                    f.write(f"3 {face[0]} {face[1]} {face[2]}\n".encode())
