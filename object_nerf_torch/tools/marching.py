"""Iso-surface extraction via marching tetrahedra (vectorized numpy).

Own copy of `object_nerf_tpu/tools/marching.py`. Replaces the reference's
PyMCubes dependency (tools/extract_mesh.py:120): the same capability,
extracting the sigma-threshold surface of a dense grid as a triangle mesh,
with the table-light marching-tetrahedra variant (each cube splits into 6
tetrahedra around the 0-6 diagonal; every tet emits 0-2 triangles). Produces
watertight, vertex-shared meshes with about twice the triangle count of
classic marching cubes.

Memory-bounded: the grid is processed in z-slabs so 512^3 volumes fit.
Includes the reference's largest-connected-component cleanup
(extract_mesh.py:172-178) via union-find over shared vertices.
"""

from __future__ import annotations

import numpy as np

# cube corner offsets, bit order (x, y, z)
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], dtype=np.int64,
)

# 6-tet decomposition of the cube around the 0-6 diagonal
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
     [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], dtype=np.int64,
)

# tet edges by local vertex pair
_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int64
)

# triangles (as edge-index triples) per inside-bitmask case; -1 pads
_CASES = -np.ones((16, 2, 3), dtype=np.int64)
_CASES[1, 0] = (0, 1, 2)
_CASES[2, 0] = (0, 3, 4)
_CASES[3] = [(1, 3, 4), (1, 4, 2)]
_CASES[4, 0] = (1, 3, 5)
_CASES[5] = [(0, 3, 5), (0, 5, 2)]
_CASES[6] = [(0, 1, 5), (0, 5, 4)]
_CASES[7, 0] = (2, 4, 5)
_CASES[8, 0] = (2, 4, 5)
_CASES[9] = [(0, 1, 5), (0, 5, 4)]
_CASES[10] = [(0, 3, 5), (0, 5, 2)]
_CASES[11, 0] = (1, 3, 5)
_CASES[12] = [(1, 3, 4), (1, 4, 2)]
_CASES[13, 0] = (0, 3, 4)
_CASES[14, 0] = (0, 1, 2)


def _slab_triangles(vol, level, z0, full_nz):
    """Extract (T, 3, 2) edge-endpoint global ids + (T, 3) interp weights for
    one z-slab. Global point id = flat index into the *full* grid (z stride
    full_nz, not the slab extent).

    Cubes entirely inside or outside the surface (the overwhelming majority
    of a large grid: only a few % straddle the level set) are culled up front
    with shifted boolean views + a packed per-cube corner bitmask, so the
    6-tet table work and all index arithmetic only touch surface cubes."""
    nx, ny, nzs = vol.shape
    cx, cy, cz = nx - 1, ny - 1, nzs - 1
    inside = vol >= level
    # bit c of a cube's mask = "corner c inside", built from 8 shifted
    # views (no (C, 8, 3) index tensors)
    bits = np.zeros((cx, cy, cz), np.uint8)
    for c, (ox, oy, oz) in enumerate(_CORNERS):
        bits |= inside[ox:ox + cx, oy:oy + cy, oz:oz + cz].astype(
            np.uint8
        ) << c
    flat = bits.reshape(-1)
    act = np.flatnonzero((flat != 0) & (flat != 255))  # surface cubes only
    if act.size == 0:
        return None
    b = flat[act].astype(np.int64)
    ax, rem = np.divmod(act, cy * cz)
    ay, az = np.divmod(rem, cz)
    # (A, 8) corner values + global flat point ids for the active cubes
    vals = np.empty((act.size, 8), vol.dtype)
    for c, (ox, oy, oz) in enumerate(_CORNERS):
        vals[:, c] = vol[ax + ox, ay + oy, az + oz]
    gid0 = (ax * ny + ay) * full_nz + (az + z0)
    goff = (_CORNERS[:, 0] * ny + _CORNERS[:, 1]) * full_nz + _CORNERS[:, 2]
    gids = gid0[:, None] + goff[None, :]

    tris_a, tris_b, tris_w = [], [], []
    for t in range(6):
        # per-tet inside bitmask straight from the packed cube bits
        case = (
            ((b >> _TETS[t, 0]) & 1)
            | (((b >> _TETS[t, 1]) & 1) << 1)
            | (((b >> _TETS[t, 2]) & 1) << 2)
            | (((b >> _TETS[t, 3]) & 1) << 3)
        )
        active = (case != 0) & (case != 15)
        if not active.any():
            continue
        tv = vals[active][:, _TETS[t]]  # (M, 4)
        tg = gids[active][:, _TETS[t]]
        case = case[active]
        tri_edges = _CASES[case]  # (M, 2, 3) edge ids or -1
        for k in range(2):
            ek = tri_edges[:, k, :]  # (M, 3)
            ok = ek[:, 0] >= 0
            if not ok.any():
                continue
            e = ek[ok]
            vv, gg = tv[ok], tg[ok]
            pa = _EDGES[e][..., 0]  # (M', 3) local vertex a per corner
            pb = _EDGES[e][..., 1]
            va = np.take_along_axis(vv, pa, axis=1)
            vb = np.take_along_axis(vv, pb, axis=1)
            ga = np.take_along_axis(gg, pa, axis=1)
            gb = np.take_along_axis(gg, pb, axis=1)
            denom = vb - va
            denom = np.where(np.abs(denom) < 1e-12, 1e-12, denom)
            w = (level - va) / denom  # (M', 3)
            tris_a.append(ga)
            tris_b.append(gb)
            tris_w.append(np.clip(w, 0.0, 1.0))
    if not tris_a:
        return None
    return np.concatenate(tris_a), np.concatenate(tris_b), np.concatenate(tris_w)


def marching_tetrahedra(volume: np.ndarray, level: float, slab: int = 32,
                        backend: str = "auto"):
    """volume (X, Y, Z) -> (vertices (V, 3) in index coords, faces (F, 3)).

    Vertices on shared cube edges are merged (watertight surface).

    backend: "auto" tries the native C++ implementation first (g++-built at
    first use, `native/marching_tet.cpp`) and falls back to numpy; "native"
    requires it; "numpy" forces the numpy path (also the parity oracle of
    the native one). `marching_backend` says which of the two "auto" takes.
    """
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend in ("auto", "native"):
        from ..native import marching_tetrahedra_native

        out = marching_tetrahedra_native(volume, level)
        if out is not None:
            return out
        if backend == "native":
            raise RuntimeError("native marching library unavailable")
    nx, ny, nz = volume.shape
    all_a, all_b, all_w = [], [], []
    for z0 in range(0, nz - 1, slab):
        z1 = min(z0 + slab + 1, nz)
        out = _slab_triangles(volume[:, :, z0:z1], level, z0, nz)
        if out is not None:
            all_a.append(out[0])
            all_b.append(out[1])
            all_w.append(out[2])
    if not all_a:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    ga = np.concatenate(all_a)  # (T, 3) edge endpoint a (global point id)
    gb = np.concatenate(all_b)
    w = np.concatenate(all_w)

    lo = np.minimum(ga, gb)
    hi = np.maximum(ga, gb)
    w = np.where(ga <= gb, w, 1.0 - w)  # canonicalize direction
    keys = lo.astype(np.int64) * (nx * ny * nz) + hi
    uniq, first_idx, inverse = np.unique(
        keys.reshape(-1), return_index=True, return_inverse=True
    )
    faces = inverse.reshape(-1, 3)

    flat_lo = lo.reshape(-1)[first_idx]
    flat_hi = hi.reshape(-1)[first_idx]
    flat_w = w.reshape(-1)[first_idx]

    def unflat(g):
        x = g // (ny * nz)
        rem = g % (ny * nz)
        return np.stack([x, rem // nz, rem % nz], -1).astype(np.float64)

    pa, pb = unflat(flat_lo), unflat(flat_hi)
    verts = pa + flat_w[:, None] * (pb - pa)

    # drop degenerate faces (repeated vertex ids)
    good = (
        (faces[:, 0] != faces[:, 1])
        & (faces[:, 1] != faces[:, 2])
        & (faces[:, 0] != faces[:, 2])
    )
    return verts.astype(np.float32), faces[good].astype(np.int64)


def marching_backend(backend: str = "auto") -> str:
    """The implementation `marching_tetrahedra(backend=...)` runs: "native"
    or "numpy"."""
    if backend == "numpy":
        return "numpy"
    from ..native import load_marching_lib

    return "native" if load_marching_lib() is not None else "numpy"


def largest_connected_component(verts, faces):
    """Keep the largest vertex-connected component (extract_mesh.py:172-178).

    scipy's sparse BFS when available (a 512^3 extraction yields millions of
    faces - the union-find fallback's per-face Python loop would dominate
    the whole pipeline there); pure-numpy union-find otherwise."""
    n = len(verts)
    try:
        from scipy import sparse
        from scipy.sparse.csgraph import connected_components

        rows = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
        cols = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
        adj = sparse.coo_matrix(
            (np.ones(len(rows), np.int8), (rows, cols)), shape=(n, n)
        )
        _, roots = connected_components(adj, directed=False)
    except ImportError:
        parent = np.arange(n)

        def find(a):
            root = a
            while parent[root] != root:
                root = parent[root]
            while parent[a] != root:
                parent[a], a = root, parent[a]
            return root

        for f in faces:
            ra, rb, rc = find(f[0]), find(f[1]), find(f[2])
            parent[rb] = ra
            parent[rc] = ra
        roots = np.array([find(i) for i in range(n)])
    vals, counts = np.unique(roots, return_counts=True)
    keep_root = vals[np.argmax(counts)]
    keep_mask = roots == keep_root
    remap = -np.ones(n, np.int64)
    remap[keep_mask] = np.arange(keep_mask.sum())
    face_keep = keep_mask[faces].all(axis=1)
    return verts[keep_mask], remap[faces[face_keep]]
