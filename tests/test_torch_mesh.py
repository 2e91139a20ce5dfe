"""The port's mesh path (TSDF integrate, marching tetrahedra, cleaning, the
z-buffer, subdivision, ICP, the 2D metric, PLY I/O) against the JAX
package's, on tests/test_mesh.py's cases and on fused volumes from a
numpy seed.

Tolerances: integrate weights and colours exact, and the slabbed
integrate equal to the bit to the whole-grid one; tsdf within two float32
ulps of the views' largest depth over sdf_trunc (5.3e-6 here): XLA on the
CPU contracts the voxel coordinate's origin + voxel * index into a fused
multiply-add on two of the three axes and not on the third, PyTorch
rounds the product and the sum apart, so a voxel's camera depth can differ
by one ulp and sdf / sdf_trunc carries it; marching_cubes faces identical and
vertices within 1e-12 on the same volume (on the two packages' fused
volumes, faces identical and vertices within 1e-5 m, the tsdf's ulps moving
the crossing points); clean_mesh exact; render_mesh_depth within 1e-5;
subdivide_to_edge exact; icp_align within 1e-9; calc_2d_metric within 1e-4
cm; PLY files byte-identical for the same arrays and each package reading
the other's files back exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import np_, one_thread  # noqa: F401
from vtgaussian_slam_tpu.eval import mesh as JM
from vtgaussian_slam_tpu.eval import plyio as JP
from vtgaussian_slam_tpu_torch.eval import mesh as TM
from vtgaussian_slam_tpu_torch.eval import plyio as TP


def sphere_sdf_grid(n=40, r=0.35):
    ax = np.linspace(-0.5, 0.5, n)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.sqrt(x * x + y * y + z * z) - r


def _views(seed=0, n=3, H=48, W=64):
    """n RGB-D views of a bumpy wall about 2 m away, with depth holes,
    from slightly different poses."""
    rng = np.random.default_rng(seed)
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    out = []
    for i in range(n):
        yy, xx = np.mgrid[0:H, 0:W]
        depth = (2.0 + 0.1 * np.sin(xx / 7.0 + i) + 0.05 * np.cos(yy / 5.0)
                 + rng.normal(0, 0.003, (H, W))).astype(np.float32)
        depth[rng.uniform(size=(H, W)) < 0.05] = 0.0
        color = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
        w2c = np.eye(4)
        w2c[:3, 3] = [0.03 * i, -0.02 * i, 0.01 * i]
        a = 0.02 * i
        w2c[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                       [-np.sin(a), 0, np.cos(a)]]
        out.append((color, depth, K, w2c))
    return out


BOUNDS = ([-1.6, -1.2, 1.6], [1.6, 1.2, 2.5])


def _fused(slab_voxels=None):
    j = JM.TSDFVolume(*BOUNDS, voxel_length=0.03, sdf_trunc=0.09)
    kw = {} if slab_voxels is None else dict(slab_voxels=slab_voxels)
    t = TM.TSDFVolume(*BOUNDS, voxel_length=0.03, sdf_trunc=0.09,
                      device="cpu", **kw)
    for view in _views():
        j.integrate(*view)
        t.integrate(*view)
    return j, t


@pytest.fixture(scope="module")
def fused():
    return _fused()


def test_integrate_matches(fused):
    j, t = fused
    assert t.dims == j.dims
    np.testing.assert_array_equal(np_(t.weight), np.asarray(j.weight))
    max_depth = max(float(v[1].max()) for v in _views())
    atol = 2 * float(np.spacing(np.float32(max_depth))) / 0.09
    np.testing.assert_allclose(np_(t.tsdf), np.asarray(j.tsdf), atol=atol,
                               rtol=0)
    np.testing.assert_array_equal(np_(t.color), np.asarray(j.color))
    assert np.asarray(j.weight).max() == 3.0


def test_slabbed_integrate_is_bit_identical(fused):
    _, whole = fused
    _, slabbed = _fused(slab_voxels=25000)
    assert 1 < slabbed.slab < slabbed.dims[0]     # several slabs
    for a, b in ((slabbed.tsdf, whole.tsdf), (slabbed.weight, whole.weight),
                 (slabbed.color, whole.color)):
        assert torch.equal(a, b)


def _same_mesh(got, want):
    (tv, tf), (jv, jf) = got, want
    np.testing.assert_array_equal(tf, jf)
    assert tv.dtype == np.float64 and tv.shape == np.asarray(jv).shape
    np.testing.assert_allclose(tv, jv, atol=1e-12, rtol=0)


def test_marching_cubes_sphere():
    vol = sphere_sdf_grid()
    got = TM.marching_cubes(vol, 0.0)
    _same_mesh(got, JM.marching_cubes(vol, 0.0))
    assert len(got[1]) > 100


def test_marching_cubes_empty_and_nan():
    _same_mesh(TM.marching_cubes(np.ones((8, 8, 8)), 0.0),
               JM.marching_cubes(np.ones((8, 8, 8)), 0.0))
    vol = sphere_sdf_grid(24)
    vol[:12] = np.nan
    got = TM.marching_cubes(torch.as_tensor(vol), 0.0)
    _same_mesh(got, JM.marching_cubes(vol, 0.0))
    assert np.all(got[0][:, 0] >= 11.0)


def test_extract_and_colors_match(fused):
    j, t = fused
    jv, jf = j.extract_mesh()
    tv, tf = t.extract_mesh()
    np.testing.assert_array_equal(tf, jf)
    # the tsdf's ulp-level differences move an edge's crossing point
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
    assert len(tf) > 500
    np.testing.assert_allclose(t.vertex_colors(jv), j.vertex_colors(jv),
                               atol=1e-6, rtol=0)


def test_clean_mesh_exact(fused):
    j, _ = fused
    v, f = j.extract_mesh()
    for min_verts in (10, 200):
        tv, tf = TM.clean_mesh(v, f, min_verts)
        jv, jf = JM.clean_mesh(v, f, min_verts)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tv, jv)
    acc_t = TM.accuracy_completion(v, f, v, f, n_samples=5000)
    acc_j = JM.accuracy_completion(v, f, v, f, n_samples=5000)
    assert acc_t == acc_j


def _quad(z, r):
    return [[-r, -r, z], [r, -r, z], [r, r, z], [-r, r, z]]


K_CAM = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)


def _depth_cases():
    slant_v = np.array([[-0.2, -0.2, 1.8], [0.2, -0.2, 2.2],
                        [0.2, 0.2, 2.2], [-0.2, 0.2, 1.8]])
    slant = TM.subdivide_to_edge(slant_v, np.array([[0, 1, 2], [0, 2, 3]]),
                                 0.05)
    return {
        "quad": (np.asarray(_quad(2.0, 0.1), np.float32),
                 np.array([[0, 1, 2], [0, 2, 3]], np.int32)),
        "occlusion": (np.asarray(_quad(2.0, 0.2) + _quad(1.5, 0.05),
                                 np.float32),
                      np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]],
                               np.int32)),
        "slant": slant,
    }


@pytest.mark.parametrize("case", ["quad", "occlusion", "slant"])
def test_render_mesh_depth_matches(case):
    v, f = _depth_cases()[case]
    want = np.asarray(JM.render_mesh_depth(
        jnp.asarray(v), jnp.asarray(f), jnp.eye(4, dtype=jnp.float32),
        jnp.asarray(K_CAM), 48, 64))
    got = np_(TM.render_mesh_depth(torch.as_tensor(v), torch.as_tensor(f),
                                   torch.eye(4), torch.as_tensor(K_CAM), 48,
                                   64, chunk=3))
    assert (got > 0).sum() > 10
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_subdivide_and_icp_match():
    v = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0]])
    f = np.array([[0, 1, 2]])
    for rounds in (None, 8):
        tv, tf = TM.subdivide_to_edge(v, f, 0.3, max_rounds=rounds)
        jv, jf = JM.subdivide_to_edge(v, f, 0.3, max_rounds=rounds)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
    rng = np.random.default_rng(0)
    src = rng.uniform(-1, 1, (2000, 3))
    ang = np.deg2rad(3.0)
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
    dst = src @ R.T + np.array([0.05, -0.03, 0.02])
    np.testing.assert_allclose(TM.icp_align(src, dst), JM.icp_align(src, dst),
                               atol=1e-9, rtol=0)


def box_mesh(half=1.5, max_edge=0.12):
    s = half
    v = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                  for z in (-s, s)], np.float64)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    faces = []
    for a, b, c, d in quads:
        faces += [[a, b, c], [a, c, d]]
    return JM.subdivide_to_edge(v, np.array(faces), max_edge, max_rounds=8)


@pytest.mark.parametrize("case", ["identical", "shifted", "unseen"])
def test_calc_2d_metric_matches(case):
    v, f = box_mesh()
    kw = dict(align=False, seed=1, h=100, w=100, focal=50.0, max_edge=0.12)
    rec = v + np.array([0.05, 0, 0]) if case == "shifted" else v
    if case == "unseen":
        g = np.arange(400) + 0.5
        phi = np.arccos(1 - 2 * g / 400)
        theta = np.pi * (1 + 5 ** 0.5) * g
        sph = 5.0 * np.stack([np.sin(phi) * np.cos(theta),
                              np.sin(phi) * np.sin(theta), np.cos(phi)], -1)
        kw.update(pc_unseen=sph, n_imgs=2, max_tries=20)
    else:
        kw.update(n_imgs=3)
    got = TM.calc_2d_metric(rec, f, v, f, device="cpu", **kw)["depth l1"]
    want = JM.calc_2d_metric(rec, f, v, f, **kw)["depth l1"]
    if case == "unseen":
        assert np.isnan(got) and np.isnan(want)
    else:
        assert abs(got - want) <= 1e-4, (got, want)
    if case == "identical":
        assert got == 0.0
    if case == "shifted":
        assert 0.5 < got < 30.0


def test_ply_round_trips_across_packages(tmp_path):
    rng = np.random.default_rng(3)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    f = rng.integers(0, 50, (80, 3)).astype(np.int32)
    c = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    for colors in (c, None):
        pt, pj = tmp_path / "port.ply", tmp_path / "jax.ply"
        TP.write_ply(str(pt), v, f, colors)
        JP.write_ply(str(pj), v, f, colors)
        assert pt.read_bytes() == pj.read_bytes()
        for reader in (TP.read_ply, JP.read_ply):
            for path in (pt, pj):
                rv, rf, rc = reader(str(path))
                np.testing.assert_array_equal(rv, v)
                np.testing.assert_array_equal(rf, f)
                if colors is None:
                    assert rc is None
                else:
                    np.testing.assert_allclose(rc, np.round(c * 255) / 255,
                                               atol=1 / 255 + 1e-6)
    ascii_ply = tmp_path / "quads.ply"
    ascii_ply.write_text(
        "ply\nformat ascii 1.0\nelement vertex 4\nproperty float x\n"
        "property float y\nproperty float z\nelement face 1\n"
        "property list uchar int vertex_indices\nend_header\n"
        "0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n")
    for (tv, tf, _), (jv, jf, _) in [(TP.read_ply(str(ascii_ply)),
                                      JP.read_ply(str(ascii_ply)))]:
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tf, jf)
        assert tf.shape == (2, 3)
