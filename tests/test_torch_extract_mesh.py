"""The port's mesh-extraction path (object_nerf_torch/tools, native/,
data/ply_io.py) against the JAX package's.

`extract_sigma_grid` on `device="cpu"` (plain version, f32) against the JAX
tool's sweep through XLA and through its Pallas kernel in interpret mode,
scene and object branch, with a chunk that does not divide the grid; the
synthesised grid points bit for bit against the formula on host-built axes,
up to the last index of a 512^3 grid; the marching-tetrahedra and PLY copies against the
originals; the CLI end to end on a tiny model.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from object_nerf_tpu.config import Config as JaxConfig
from object_nerf_tpu.data import ply_io as jply
from object_nerf_tpu.render.renderer import RenderSettings as JaxSettings
from object_nerf_tpu.tools import marching as jmarch

from object_nerf_torch.config import Config
from object_nerf_torch.data import ply_io as tply
from object_nerf_torch.models.mlp import ObjectNeRFConfig
from object_nerf_torch.ops import fused_mlp as fm
from object_nerf_torch.tools import extract_mesh as tx
from object_nerf_torch.tools import marching as tmarch
from object_nerf_torch.train.system import ObjectNeRFModels

from _torch_port import CFG_JAX, jax_params, port_models, settings

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import extract_mesh as jx  # noqa: E402  (the JAX package's tool, tools/extract_mesh.py)

torch.set_num_threads(2)
# f32 on both sides, identical formulas, points within one last bit
ATOL = 1e-5
# the Pallas kernel in interpret mode builds its PE as sin(x @ S + phase),
# ~1e-4 off at the top frequency (tests/test_torch_fused_sigma.py)
KERNEL_ATOL = 2e-4
GRID = {"N_grid": 10, "chunk": 192,  # 1000 = 5 * 192 + 40: a short last chunk
        "x_range": [-1.0, 0.8], "y_range": [-0.5, 1.1], "z_range": [0.0, 0.9]}
JSET = JaxSettings(mlp=CFG_JAX, N_samples=16, N_importance=8, perturb=0.0, noise_std=0.0,
                   is_eval=True)


@pytest.mark.parametrize("obj_id", [0, 5])
@pytest.mark.parametrize("route", ["xla", "pallas_interpret"])
def test_sigma_grid_matches_jax_tool(obj_id, route):
    params = jax_params(seed=31)
    for branch in ("scene", "object"):  # densities on both sides of 0: the clamp bites
        b = params["fine"][branch]["sigma"]["b"]
        params["fine"][branch]["sigma"]["b"] = b - (0.1 if branch == "scene" else 0.0)
    jset = JSET if route == "xla" else dataclasses.replace(
        JSET, use_pallas=True, pallas_interpret=True, pallas_dtype="float32")
    want = jx.extract_sigma_grid(params, jset, None, JaxConfig(GRID), obj_id=obj_id)
    fm.reset_launch_counts()
    models = port_models(params)
    got = tx.extract_sigma_grid(models, settings(), Config(GRID), obj_id=obj_id, device="cpu")
    assert sum(fm.launch_counts.values()) == 0  # CPU tensors: the plain version
    assert got.shape == (10, 10, 10) and got.dtype == np.float32
    assert got.min() >= 0 and (got > 0).any() and (got == 0).any()  # clamped at the end
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ATOL if route == "xla" else KERNEL_ATOL)
    # the plain sweep (what a kernel sweep is held against on the card) is
    # the same sweep on the CPU, and a chunk that divides the grid changes nothing
    plain = tx.extract_sigma_grid(models, settings(), Config({**GRID, "chunk": 64 * 1024}),
                                  obj_id=obj_id, device="cpu", plain=True, as_tensor=True)
    assert isinstance(plain, torch.Tensor)
    np.testing.assert_array_equal(plain.numpy(), got)


def _jax_synth(conf, off, size):
    """The JAX tool's point synthesis (tools/extract_mesh.py:71-79)."""
    n = int(conf["N_grid"])
    n3 = n * n * n
    (xmin, xmax), (ymin, ymax), (zmin, zmax) = conf["x_range"], conf["y_range"], conf["z_range"]
    k = jnp.minimum(off + jnp.arange(size, dtype=jnp.int32), n3 - 1)
    i, rem = k // (n * n), k % (n * n)
    return jnp.stack([xmin + i * ((xmax - xmin) / (n - 1)),
                      ymin + (rem // n) * ((ymax - ymin) / (n - 1)),
                      zmin + (rem % n) * ((zmax - zmin) / (n - 1))], -1).astype(jnp.float32)


@pytest.mark.parametrize("n,off,size", [
    (10, 0, 1000), (10, 960, 64), (16, 0, 4096), (16, 4000, 128),
    (512, 0, 2048), (512, 512 ** 3 - 3000, 4096), (512, 77 * 512 * 512 + 300 * 512 - 7, 1024)])
def test_grid_points_bit_equal_jax_formula(n, off, size):
    """Bit for bit the formula min + index * step in float32 on host-built
    axes (x outer, y mid, z inner), the oracle of the JAX package's own test
    (tests/test_extract_mesh_cli.py:68-106); the JAX tool's compiled point
    synthesis contracts some of its products and sums into fused
    multiply-adds (which ones is the compiler's choice per program), so it is
    held to one last bit of values below 2."""
    conf = {**GRID, "N_grid": n, "x_range": [-1.5, 1.5], "z_range": [-0.3, 1.7]}
    got = tx.grid_points(Config(conf), off, size, "cpu")
    assert got.shape == (size, 3) and got.dtype == torch.float32 and got.is_contiguous()
    idx = np.arange(n, dtype=np.float32)
    axes = [np.float32(lo) + idx * np.float32((hi - lo) / (n - 1))
            for lo, hi in (conf["x_range"], conf["y_range"], conf["z_range"])]
    k = np.minimum(off + np.arange(size, dtype=np.int64), n ** 3 - 1)
    host = np.stack([axes[0][k // (n * n)], axes[1][(k // n) % n], axes[2][k % n]], -1)
    np.testing.assert_array_equal(got.numpy(), host)
    want = np.asarray(jax.jit(lambda: _jax_synth(conf, off, size))())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1.2e-7)
    assert (got.numpy() == want).mean() > 0.6


# -- marching tetrahedra and PLY: copies against the originals ---------------------------


def _volumes():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((12, 10, 11)).astype(np.float32)
    for ax in range(3):
        v = (np.roll(v, 1, ax) + v + np.roll(v, -1, ax)) / 3.0
    g = np.stack(np.meshgrid(*[np.linspace(-1, 1, 16)] * 3, indexing="ij"), -1)
    ties = np.zeros((6, 6, 6), np.float32)
    ties[2:4, 2:4, 2:4] = 0.5
    return {"smooth": (v, 0.1),
            "sphere": ((1.0 - np.linalg.norm(g, axis=-1)).astype(np.float32), 0.0),
            "ties": (ties, 0.5),
            "empty": (np.zeros((5, 5, 5), np.float32), 0.5)}


def _soup(verts, faces):
    """Faces as corner coordinates, each rotated to start at its smallest
    corner (winding kept), rows sorted: vertex and face order are an
    implementation detail of each backend."""
    rows = []
    for f in np.round(verts[faces].astype(np.float64), 5):
        c = [tuple(x) for x in f]
        s = min(range(3), key=lambda i: c[i])
        rows.append(c[s] + c[(s + 1) % 3] + c[(s + 2) % 3])
    return sorted(rows)


@pytest.mark.parametrize("backend", ["numpy", "auto"])
@pytest.mark.parametrize("name", list(_volumes()))
def test_marching_tetrahedra_equals_original(name, backend):
    vol, level = _volumes()[name]
    want_v, want_f = jmarch.marching_tetrahedra(vol, level, backend="numpy")
    got_v, got_f = tmarch.marching_tetrahedra(vol, level, backend=backend, slab=4)
    assert got_v.dtype == np.float32 and got_f.dtype == np.int64
    assert tmarch.marching_backend(backend) in ("native", "numpy")
    if backend == "numpy":
        assert tmarch.marching_backend(backend) == "numpy"
    assert _soup(got_v, got_f) == _soup(want_v, want_f)
    if name == "empty":
        assert len(got_v) == 0 and len(got_f) == 0
        return
    a = tmarch.largest_connected_component(got_v, got_f)
    b = jmarch.largest_connected_component(want_v, want_f)
    assert _soup(*a) == _soup(*b)
    if name == "sphere":  # closed surface: every edge is shared by two faces
        e = np.sort(np.concatenate([got_f[:, [0, 1]], got_f[:, [1, 2]], got_f[:, [2, 0]]]), 1)
        assert (np.unique(e, axis=0, return_counts=True)[1] == 2).all()


def test_marching_backend_argument():
    vol, level = _volumes()["sphere"]
    with pytest.raises(ValueError, match="unknown backend"):
        tmarch.marching_tetrahedra(vol, level, backend="cuda")
    if tmarch.marching_backend("auto") == "native":
        v, f = tmarch.marching_tetrahedra(vol, level, backend="native")
        assert len(v) and len(f)
        from object_nerf_torch import native

        assert native.BUILD_DIR == ROOT / "object_nerf_torch" / "_build"
        assert list(native.BUILD_DIR.glob("marching_tet-*.so"))
    else:
        with pytest.raises(RuntimeError, match="unavailable"):
            tmarch.marching_tetrahedra(vol, level, backend="native")


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("with_colors,with_faces", [(True, True), (False, True), (True, False),
                                                    (False, False)])
def test_ply_files_equal_the_originals(tmp_path, binary, with_colors, with_faces):
    rng = np.random.RandomState(0)
    pts = rng.randn(40, 3).astype(np.float32)
    colors = rng.rand(40, 3).astype(np.float32) if with_colors else None
    faces = rng.randint(0, 40, (25, 3)) if with_faces else None
    tply.write_ply(tmp_path / "port.ply", pts, colors=colors, faces=faces, binary=binary)
    jply.write_ply(tmp_path / "orig.ply", pts, colors=colors, faces=faces, binary=binary)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "orig.ply").read_bytes()
    got, want = tply.read_ply(tmp_path / "orig.ply"), jply.read_ply(tmp_path / "port.ply")
    assert set(got) == set(want)
    for k in want:
        if want[k] is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["points"], pts, atol=1e-6)
    if with_faces:
        np.testing.assert_array_equal(np.asarray(got["faces"]), faces)


def test_read_ply_takes_polygons_that_are_not_triangles(tmp_path):
    import struct

    body = b"".join(struct.pack("<3f", *p) for p in np.eye(4, 3, dtype=np.float32))
    body += struct.pack("<B4i", 4, 0, 1, 2, 3) + struct.pack("<B4i", 4, 3, 2, 1, 0)
    head = ("ply\nformat binary_little_endian 1.0\nelement vertex 4\nproperty float x\n"
            "property float y\nproperty float z\nelement face 2\n"
            "property list uchar int vertex_indices\nend_header\n").encode()
    (tmp_path / "quad.ply").write_bytes(head + body)
    got, want = tply.read_ply(tmp_path / "quad.ply"), jply.read_ply(tmp_path / "quad.ply")
    assert [list(f) for f in got["faces"]] == [list(f) for f in want["faces"]] \
        == [[0, 1, 2, 3], [3, 2, 1, 0]]


# -- the CLI ---------------------------------------------------------------------------------

TINY = [
    f"dataset_config={ROOT / 'config/synthetic.yml'}", "model.use_voxel_embedding=false",
    "model.D=2", "model.W=32", "model.skips=[1]", "model.inst_D=2", "model.inst_W=16",
    "model.inst_skips=[1]", "model.N_samples=8", "model.N_importance=4",
    "model.N_max_objs=8", "model.N_obj_code_length=8", "dataset_extra.scale_factor=2.0",
]


def _blob_checkpoint(path):
    """A tiny model whose density is a smooth blob around the origin (a
    random first layer, the density head reading minus the squared distance
    through it is not needed: the raised bias and a threshold between the
    field's extremes cut a surface)."""
    cfg = ObjectNeRFConfig(D=2, W=32, skips=(1,), inst_D=2, inst_W=16, inst_skips=(1,),
                           use_voxel_embedding=False, N_obj_code_length=8)
    models = ObjectNeRFModels(cfg, n_importance=1, n_max_objs=8)
    g = torch.Generator().manual_seed(3)
    for m in (models.nerf_coarse, models.nerf_fine):
        m.reset_parameters_(g)
    models.code_library.reset_parameters_(g)
    torch.save({"state_dict": models.state_dict()}, path)
    return models, cfg


@pytest.mark.parametrize("obj_id", [0, 3])
def test_extract_mesh_cli_end_to_end(tmp_path, capsys, obj_id):
    models, cfg = _blob_checkpoint(tmp_path / "model.ckpt")
    grid = ["N_grid=14", "chunk=1000", "x_range=[-1.2,1.2]", "y_range=[-1.0,1.2]",
            "z_range=[-0.5,1.2]"]
    conf = Config.from_dotlist(grid)
    field = tx.extract_sigma_grid(models, settings(mlp=cfg), conf, obj_id=obj_id, device="cpu")
    level = float(np.median(field[field > 0]))  # a level that cuts the field
    tx.main(TINY + grid + [
        f"ckpt_path={tmp_path / 'model.ckpt'}", f"obj_id={obj_id}", "device=cpu",
        f"sigma_threshold={level}", "predict_color=true", "prefix=test",
        f"out_dir={tmp_path}", "keep_largest_component=true"])
    out = capsys.readouterr().out
    assert "wrote" in out and "marching backend" in out and " on cpu" in out, out
    mesh = tply.read_ply(tmp_path / "extracted_mesh_test.ply")
    verts, colors, faces = mesh["points"], mesh["colors"], np.asarray(mesh["faces"])
    assert len(verts) > 0 and len(faces) > 0 and faces.max() < len(verts)
    assert colors is not None and colors.shape == (len(verts), 3)
    # world coordinates: index -> range with the reference's x/y swap, times
    # the scale factor of 2
    assert verts[:, 0].min() >= 2 * -1.0 - 1e-4 and verts[:, 0].max() <= 2 * 1.2 + 1e-4
    assert verts[:, 1].min() >= 2 * -1.2 - 1e-4 and verts[:, 1].max() <= 2 * 1.2 + 1e-4
    assert verts[:, 2].min() >= 2 * -0.5 - 1e-4 and verts[:, 2].max() <= 2 * 1.2 + 1e-4


def test_extract_mesh_cli_refuses_what_is_not_ported(tmp_path):
    _blob_checkpoint(tmp_path / "model.ckpt")
    with pytest.raises(SystemExit, match="ckpt_path"):
        tx.main(TINY + ["device=cpu"])
    # a voxel-conditioned model needs a checkpoint that brings its grid
    with pytest.raises(SystemExit, match="voxel grid"):
        tx.main([a for a in TINY if "use_voxel" not in a]
                + ["model.use_voxel_embedding=true", f"ckpt_path={tmp_path / 'model.ckpt'}",
                   "device=cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tx.main(TINY + [f"ckpt_path={tmp_path / 'model.ckpt'}"])  # default: cuda
