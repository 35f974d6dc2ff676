"""Scene, pose and box visualisation without open3d, and the instance-map
inspector without cv2 or matplotlib.

Own copy of `object_nerf_tpu/tools/visualize.py`. `SceneVisualizer` and
`visualize_scene` are the same code (`:39-172`) over the port's `ply_io`:
geometry exports to PLY (camera frusta, trajectory polylines and box
wireframes as coloured point strips, loadable in any viewer) or to the
standalone WebGL viewer of `html_viewer.py`, and the same calls give the same
files. `visualize_instance_2d` (`:175-203`) reads and writes through the
port's PNG codec and draws the map itself (see its docstring), so it runs
where only numpy is installed.
"""

from __future__ import annotations

import numpy as np

from ..data.image_utils import resize_nearest
from ..data.ply_io import read_ply, write_ply
from ..data.png_io import PNGError, read_png, write_png


def _segment_points(a, b, n=32):
    t = np.linspace(0.0, 1.0, n)[:, None]
    return a[None] * (1 - t) + b[None] * t


def _bbox_corners(bounds):
    mn, mx = np.asarray(bounds[0]), np.asarray(bounds[1])
    return np.array(
        [[x, y, z] for x in (mn[0], mx[0]) for y in (mn[1], mx[1])
         for z in (mn[2], mx[2])]
    )


_BOX_EDGES = [
    (0, 1), (0, 2), (1, 3), (2, 3), (4, 5), (4, 6), (5, 7), (6, 7),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


class SceneVisualizer:
    """Accumulates coloured geometry; `save(path)` writes one PLY or, when
    the path ends in `.html`, a standalone interactive WebGL viewer (orbit,
    pan, zoom, layer toggles, 3D text labels: the reference's O3dVisualizer
    surface, tools/O3dVisualizer.py:25-223, without open3d)."""

    def __init__(self):
        self._pts = []
        self._colors = []
        self._tags = []  # per-block provenance: "points" | "strip" | "mesh"
        self._segments = []  # (a, b, color): native lines for the viewer
        self._meshes = []  # dicts: vertices/faces/colors
        self._labels = []  # dicts: position/text

    def add_points(self, pts, color=(0.7, 0.7, 0.7), colors=None, _tag="points"):
        pts = np.asarray(pts, np.float32).reshape(-1, 3)
        self._pts.append(pts)
        self._tags.append(_tag)
        if colors is not None:
            self._colors.append(np.asarray(colors, np.float32).reshape(-1, 3))
        else:
            self._colors.append(np.tile(np.asarray(color, np.float32), (len(pts), 1)))

    def add_line(self, a, b, color=(1, 0, 0), samples=32):
        a = np.asarray(a, float)
        b = np.asarray(b, float)
        self._segments.append((a, b, np.asarray(color, np.float32)))
        self.add_points(_segment_points(a, b, samples), color, _tag="strip")

    def add_mesh(self, vertices, faces, color=(0.8, 0.8, 0.85), colors=None):
        """Triangle mesh (e.g. a PLY of `tools/extract_mesh.py`). The PLY
        export keeps the vertices as points; the HTML viewer shades triangles."""
        vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
        faces = np.asarray(faces, np.int64).reshape(-1, 3)
        if colors is not None:
            colors = np.asarray(colors, np.float32).reshape(-1, 3)
        self._meshes.append(
            {"vertices": vertices, "faces": faces, "colors": colors,
             "color": np.asarray(color, np.float32)}
        )
        self.add_points(vertices, color=color, colors=colors, _tag="mesh")

    def add_label(self, position, text):
        """3D-anchored text (the reference's text_3d, O3dVisualizer.py)."""
        self._labels.append(
            {"position": np.asarray(position, float).reshape(3),
             "text": str(text)}
        )

    def add_bbox(self, bounds, transform=None, color=(1, 0, 0)):
        """bounds (2, 3) [min; max]; optional (4, 4) box -> world transform."""
        corners = _bbox_corners(bounds)
        if transform is not None:
            T = np.asarray(transform)
            corners = corners @ T[:3, :3].T + T[:3, 3]
        for i, j in _BOX_EDGES:
            self.add_line(corners[i], corners[j], color)

    def add_camera(self, c2w, scale=0.1, color=(0, 0.6, 1)):
        """Draw a camera frustum for a (3|4, 4) c2w pose."""
        c2w = np.asarray(c2w)
        origin = c2w[:3, 3]
        R = c2w[:3, :3]
        # image-plane corners in camera coords (x right, y up, -z forward)
        for sx in (-1, 1):
            for sy in (-1, 1):
                corner = origin + R @ (np.array([sx * 0.5, sy * 0.375, -1.0]) * scale)
                self.add_line(origin, corner, color)

    def add_trajectory(self, poses, color=(0, 1, 0)):
        centers = np.asarray([p[:3, 3] for p in poses])
        for a, b in zip(centers[:-1], centers[1:]):
            self.add_line(a, b, color)

    def save(self, path):
        if str(path).endswith(".html"):
            return self.save_html(path)
        pts = np.concatenate(self._pts) if self._pts else np.zeros((0, 3))
        colors = np.concatenate(self._colors) if self._colors else None
        write_ply(path, pts, colors=colors)
        return path

    def save_html(self, path, title="object-nerf-tpu scene"):
        from .html_viewer import write_html_viewer

        layers = []
        # the viewer draws lines and meshes natively: only "points"-tagged
        # blocks become the point layer (strips and mesh vertices are PLY-only)
        pure_pts = [b for b, t in zip(self._pts, self._tags) if t == "points"]
        pure_cols = [c for c, t in zip(self._colors, self._tags) if t == "points"]
        if pure_pts:
            layers.append({
                "name": "points", "kind": "points",
                "positions": np.concatenate(pure_pts),
                "colors": np.concatenate(pure_cols),
            })
        if self._segments:
            seg_pos = np.concatenate(
                [np.stack([a, b]) for a, b, _ in self._segments]
            ).astype(np.float32)
            seg_col = np.concatenate(
                [np.stack([c, c]) for _, _, c in self._segments]
            ).astype(np.float32)
            layers.append({"name": "lines", "kind": "lines",
                           "positions": seg_pos, "colors": seg_col})
        for i, m in enumerate(self._meshes):
            tri = m["vertices"][m["faces"].reshape(-1)]
            cols = (
                m["colors"][m["faces"].reshape(-1)]
                if m["colors"] is not None
                else np.tile(m["color"], (len(tri), 1))
            )
            layers.append({"name": f"mesh_{i}", "kind": "mesh",
                           "positions": tri, "colors": cols})
        return write_html_viewer(path, layers, labels=self._labels, title=title)


def visualize_scene(pcd_path=None, poses=None, bboxes=None, out="scene_vis.ply"):
    """One-call version of the reference scene_visualizer CLI."""
    vis = SceneVisualizer()
    if pcd_path:
        mesh = read_ply(pcd_path)
        vis.add_points(mesh["points"], colors=mesh["colors"])
    for pose in poses or []:
        vis.add_camera(pose)
    if poses:
        vis.add_trajectory(poses)
    for b in bboxes or []:
        vis.add_bbox(**b) if isinstance(b, dict) else vis.add_bbox(b)
    return vis.save(out)


# matplotlib's "tab20" (a ListedColormap of 20 colours, each n / 255)
TAB20 = np.array([
    (31, 119, 180), (174, 199, 232), (255, 127, 14), (255, 187, 120), (44, 160, 44),
    (152, 223, 138), (214, 39, 40), (255, 152, 150), (148, 103, 189), (197, 176, 213),
    (140, 86, 75), (196, 156, 148), (227, 119, 194), (247, 182, 210), (127, 127, 127),
    (199, 199, 199), (188, 189, 34), (219, 219, 141), (23, 190, 207), (158, 218, 229),
], np.uint8)

# 3 x 5 bitmap digits, one string of rows each
_GLYPHS = {
    "0": ("111", "101", "101", "101", "111"), "1": ("010", "110", "010", "010", "111"),
    "2": ("111", "001", "111", "100", "111"), "3": ("111", "001", "111", "001", "111"),
    "4": ("101", "101", "111", "001", "001"), "5": ("111", "100", "111", "001", "111"),
    "6": ("111", "100", "111", "101", "111"), "7": ("111", "001", "001", "001", "001"),
    "8": ("111", "101", "111", "101", "111"), "9": ("111", "101", "111", "001", "111"),
}


def tab20_index(inst: np.ndarray) -> np.ndarray:
    """The tab20 entry of every pixel as `imshow(inst, cmap="tab20")` picks
    it: `Normalize(min, max)` in float32 (matplotlib's type for integer data
    of up to 16 bits), then min(floor(20 x), 19); all 0 when min == max."""
    x = np.asarray(inst).astype(np.float32)
    lo, hi = x.min(), x.max()
    if lo == hi:
        return np.zeros(x.shape, np.int64)
    x = (x - lo) / (hi - lo)
    x *= np.float32(len(TAB20))
    return np.minimum(x.astype(np.int64), len(TAB20) - 1)


def _text_bitmap(text: str) -> np.ndarray:
    """(5, 4 * len - 1) bool glyphs of `text`, one column between digits."""
    cols = []
    for k, ch in enumerate(text):
        if k:
            cols.append(np.zeros((5, 1), bool))
        cols.append(np.array([[c == "1" for c in row] for row in _GLYPHS[ch]]))
    return np.concatenate(cols, axis=1)


def _label_scale(shape) -> int:
    return max(1, min(shape[:2]) // 120)


def label_boxes(inst: np.ndarray):
    """[(id, y0, y1, x0, x1)]: the box each id's label takes in the overlay,
    centred on the id's centroid (`xs.mean()`, `ys.mean()`, as
    `object_nerf_tpu/tools/visualize.py:197-201` places its text) and moved
    inside the image where it would cross an edge. Digits are 3 x 5 pixels
    times a scale of max(1, min(H, W) // 120), with a border of one scale."""
    h, w = inst.shape
    s = _label_scale(inst.shape)
    out = []
    for i in np.unique(inst):
        ys, xs = np.nonzero(inst == i)
        bh, bw = 7 * s, (4 * len(str(int(i))) + 1) * s
        y0 = int(np.clip(round(float(ys.mean())) - bh // 2, 0, max(h - bh, 0)))
        x0 = int(np.clip(round(float(xs.mean())) - bw // 2, 0, max(w - bw, 0)))
        out.append((int(i), y0, min(y0 + bh, h), x0, min(x0 + bw, w)))
    return out


def visualize_instance_2d(instance_path, out_path=None, img_wh=None):
    """Instance-map inspection (the reference's visualize_instance_2d.py):
    prints the instance ids present with their pixel counts, writes the map
    coloured by matplotlib's tab20 (`tab20_index`) with each id drawn at its
    centroid, white digits on a half-dark box (`label_boxes`), and returns
    (out_path, {id: pixel count}).

    The map is a grey PNG of 8 or 16 bits, read as cv2's IMREAD_ANYDEPTH
    reads it; `img_wh` resizes it as cv2's INTER_NEAREST. A colour PNG is
    refused (cv2 would convert it to grey). The overlay is a PNG at the
    map's own resolution (after `img_wh`), not the JAX package's matplotlib
    figure (title, axes, 8 x 6 inches at 100 dpi)."""
    inst = read_png(instance_path)
    if inst.ndim != 2:
        raise PNGError(f"{instance_path}: an instance map is a grey PNG, this one has "
                       f"{inst.shape[-1]} channels")
    if img_wh:
        inst = resize_nearest(inst, img_wh)
    ids, counts = np.unique(inst, return_counts=True)
    print("instance ids:", {int(i): int(c) for i, c in zip(ids, counts)})

    rgb = TAB20[tab20_index(inst)]
    s = _label_scale(inst.shape)
    for i, y0, y1, x0, x1 in label_boxes(inst):
        rgb[y0:y1, x0:x1] //= 2
        glyph = np.kron(_text_bitmap(str(i)), np.ones((s, s), bool))
        patch = rgb[y0 + s:y1 - s, x0 + s:x1 - s]
        patch[glyph[:patch.shape[0], :patch.shape[1]]] = 255
    out_path = out_path or str(instance_path) + ".vis.png"
    write_png(out_path, rgb)
    return out_path, {int(i): int(c) for i, c in zip(ids, counts)}
