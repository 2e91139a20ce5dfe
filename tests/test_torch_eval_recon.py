"""`eval_recon` (mesh reconstruction evaluation) in the port against the
JAX package's.

The port's engine runs the smoke config for 4 frames (3 iterations per
phase); its export goes to both packages' `eval_recon` at voxel 0.05 m,
sdf_trunc 0.12 and a pair budget of 256 (the JAX side on its XLA blend,
the port's on the plain K4), as tests/test_e2e_synthetic.py calls it.

Tolerances: n_verts and n_faces equal; every face's corners within 1 mm
(2% of the voxel) and 99.9% of them within 0.1 mm: the renders agree to
~1e-6 m of depth, which moves the tsdf's zero crossings by micrometres,
more on an edge that the surface meets at a grazing angle, and the weld
may then number two neighbouring vertices the other way round; the PLY written by the port
read back by the JAX reader; the self-score (the mesh against itself)
under 3 cm for accuracy and completion, and the 2D depth L1 of 3 views
near 0."""
import os

import numpy as np
import pytest

from torch_port_util import one_thread, smoke_config  # noqa: F401
from vtgaussian_slam_tpu.core.pipeline import build_dataset as j_build
from vtgaussian_slam_tpu.eval import eval_recon as j_eval_recon
from vtgaussian_slam_tpu.eval.plyio import read_ply as j_read_ply
from vtgaussian_slam_tpu_torch.core.pipeline import VTGaussianSLAM
from vtgaussian_slam_tpu_torch.eval import eval_recon

FRAMES = 4
RECON = dict(eval_every=1, baseframe_every=5, voxel_length=0.05,
             sdf_trunc=0.12)


@pytest.fixture(scope="module")
def export(tmp_path_factory):
    cfg = smoke_config(tmp_path_factory.mktemp("recon"), frames=11,
                       height=48, width=64)
    eng = VTGaussianSLAM(cfg, device="cpu").run(FRAMES)
    params_ls = eng.export_params_ls()
    jout = j_eval_recon(j_build(cfg), params_ls, FRAMES,
                        os.path.join(cfg["workdir"], "jax"),
                        backend_kwargs={"use_pallas": False,
                                        "max_pairs_per_tile": 256}, **RECON)
    tout = eval_recon(eng.dataset, params_ls, FRAMES,
                      os.path.join(cfg["workdir"], "port"),
                      backend_kwargs={"max_pairs_per_tile": 256},
                      device="cpu", **RECON)
    return cfg, eng, params_ls, jout, tout


def test_mesh_matches_jax(export):
    cfg, eng, params_ls, jout, tout = export
    assert tout["n_verts"] == jout["n_verts"] > 100
    assert tout["n_faces"] == jout["n_faces"] > 50
    jv, jf, jc = j_read_ply(jout["mesh_path"])
    tv, tf, tc = j_read_ply(tout["mesh_path"])
    # the weld numbers the vertices in the order of their rounded
    # coordinates, so two neighbours a few micrometres apart may swap
    # numbers: hold each face's corner coordinates
    err = np.abs(tv[tf] - jv[jf])
    assert err.max() <= 1e-3 and (err <= 1e-4).mean() >= 0.999, (
        err.max(), (err <= 1e-4).mean())
    assert tc is not None and tc.shape == tv.shape
    st = tout["stats"]
    assert st["voxel_dims"] and st["state_bytes"] > 0
    assert 0.0 <= st["masked_share"] < 1.0
    for k in ("render_s", "integrate_s", "extract_s", "clean_s", "write_s"):
        assert st[k] >= 0.0


def test_self_score(export):
    cfg, eng, params_ls, jout, tout = export
    scored = eval_recon(eng.dataset, params_ls, FRAMES,
                        os.path.join(cfg["workdir"], "self"),
                        gt_mesh_path=tout["mesh_path"], n_2d_views=3,
                        backend_kwargs={"max_pairs_per_tile": 256},
                        device="cpu", **RECON)
    assert scored["accuracy_cm"] < 3.0 and scored["completion_cm"] < 3.0
    assert scored["depth l1"] < 0.5, scored
