"""Where the port and the JAX engine part on test_torch_slice's config, and
how far the JAX engine parts from itself (a diagnostic, not a test; CPU,
imports both packages, ~1-3 minutes per mode on a warm JAX cache).

    JAX_PLATFORMS=cpu python tests/trace_slice_parity.py lockstep
    JAX_PLATFORMS=cpu python tests/trace_slice_parity.py binning
    JAX_PLATFORMS=cpu python tests/trace_slice_parity.py spread slice [SEED]
    JAX_PLATFORMS=cpu python tests/trace_slice_parity.py spread replica
    JAX_PLATFORMS=cpu python tests/trace_slice_parity.py spread tum
    JAX_PLATFORMS=cpu python tests/trace_slice_parity.py p2p

lockstep: both engines over the slice's 3 frames (the JAX engine's draws
injected), then, per mapping phase and iteration, one JAX step and one port
step from the SAME state (the JAX engine's mapping input, stepped by the
JAX side): loss, largest render difference, each side's logit-gradient
error against the port's own route in f64 (relative to the gradient's
scale), gradient sign flips, the step's logit share outside 5e-4 + 1e-3
|b| and its largest difference; per frame the two engines' mapping inputs
and outputs, and the JAX replay against the JAX engine's fused loop.

binning: frame 0's projection and binning (the slice's map cache, and the
generic route's depth-prefix window) in the JAX package's jit, in its
op-by-op evaluation and in the port, and which FMA form the jit's mean2d
takes.

spread: the port's gap to the JAX engine beside the JAX engine's gap to
itself with the input frames one ulp up (torch_port_util.jax_spread:
depth, colour, both), per section and field: (share outside the band,
largest |delta|). The boundary configs pin the nudged JAX runs' poses to
the first run's, as the tests pin the port's. Run it once more with
XLA_FLAGS=--xla_cpu_max_isa=AVX to see the JAX package without FMA
contraction.

p2p: test_torch_p2p's metric checks with their margins, per method and
seed: each side's metric gap to the port's f64 evaluation as a share of
its bound and relative to the f64 value beside the bound's, each side's
largest residual gap as a share of its rounding bound, and whether the
port's f32 metric has JAX's bits. Run it under MKL_CBWR=COMPATIBLE and
MKL_ENABLE_INSTRUCTIONS=AVX2 too: the port's rounding follows MKL's
sgemm path.
"""
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import conftest  # noqa: E402,F401  (the tests' JAX setup)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_boundaries as TB  # noqa: E402
from test_torch_slice import (FRAMES, _config, run_jax_slice,  # noqa: E402
                              run_port_slice, slice_draws)
from torch_port_util import FIELDS, band_gap, section_fields  # noqa: E402
from vtgaussian_slam_tpu.core import losses as JL  # noqa: E402
from vtgaussian_slam_tpu.core import map_cache as JMC  # noqa: E402
from vtgaussian_slam_tpu.core import pipeline as JP  # noqa: E402
from vtgaussian_slam_tpu.models import optimizer as JO  # noqa: E402
from vtgaussian_slam_tpu.ops import geometry as JG  # noqa: E402
from vtgaussian_slam_tpu.ops import image as JI  # noqa: E402
from vtgaussian_slam_tpu.ops.rasterizer import binning as JB  # noqa: E402
from vtgaussian_slam_tpu.ops.rasterizer import projection as JPR  # noqa: E402
from vtgaussian_slam_tpu.ops.rasterizer.pallas_splat import \
    pick_walk_chunk  # noqa: E402
from vtgaussian_slam_tpu_torch.core import losses as TL  # noqa: E402
from vtgaussian_slam_tpu_torch.core import map_cache as TMC  # noqa: E402
from vtgaussian_slam_tpu_torch.core import pipeline as TP  # noqa: E402
from vtgaussian_slam_tpu_torch.models import optimizer as TO  # noqa: E402
from vtgaussian_slam_tpu_torch.ops import geometry as TG  # noqa: E402
from vtgaussian_slam_tpu_torch.ops.camera import Camera as TCam  # noqa: E402
from vtgaussian_slam_tpu_torch.ops.rasterizer import binning as TBN  # noqa: E402
from vtgaussian_slam_tpu_torch.ops.rasterizer import \
    projection as TPR  # noqa: E402

JI.cv2 = None                   # the numpy Canny on both sides
torch.set_num_threads(1)


def _copy(tree):
    return jax.tree.map(lambda a: jnp.asarray(np.array(a)), tree)


def _tcam(cam):
    return TCam(height=cam.height, width=cam.width, fx=cam.fx, fy=cam.fy,
                cx=cam.cx, cy=cam.cy)


def _port_cache(stack, s):
    g = lambda x: np.array(x[s])                               # noqa: E731
    return TMC.KFBinCache(
        tab=torch.as_tensor(g(stack.tab)).long(),
        counts=torch.as_tensor(g(stack.counts)).int(),
        inv=TBN.SlotInv(torch.as_tensor(g(stack.inv.pos)).long(),
                        torch.as_tensor(g(stack.inv.w)).float()),
        quat=torch.as_tensor(g(stack.quat)),
        trans=torch.as_tensor(g(stack.trans)))


def lockstep():
    cfg = _config(tempfile.mkdtemp())
    draws = slice_draws(cfg)
    jeng, jcap, tcap, cur = JP.VTGaussianSLAM(cfg), {}, {}, {"t": 0}
    from vtgaussian_slam_tpu.core import mapping as JM

    def jmap(params, kf, stack, slot_ids, gc, rng, cam, mcfg):
        out = JM.map_frame_binned(params, kf, stack, slot_ids, gc, rng, cam,
                                  mcfg)
        jcap[cur["t"]] = dict(params=_copy(params), kf=_copy(kf),
                              stack=_copy(stack), slot_ids=np.array(slot_ids),
                              rng=_copy(rng), cam=cam, cfg=mcfg,
                              out=_copy(out[0]),
                              n=int(jeng.sections[0].n_active))
        return out

    jeng._map_binned_fn = jmap
    for t in range(FRAMES):
        cur["t"] = t
        jeng.process_frame_zero() if t == 0 else jeng.process_frame(t)
    teng = TP.VTGaussianSLAM(cfg, device="cpu",
                             map_draws=lambda t, n, c: draws[t][:n])
    tmap = teng._map_binned_fn

    def tmap_rec(params, kf, slots, slot_ids, cam, mcfg, **kw):
        out = tmap(params, kf, slots, slot_ids, cam, mcfg, **kw)
        tcap[cur["t"]] = dict(params=params, out=out[0],
                              n=teng.sections[0].n_active)
        return out

    teng._map_binned_fn = tmap_rec
    for t in range(FRAMES):
        cur["t"] = t
        teng.process_frame(t)
    f8j = lambda p: np.asarray(JMC.pack_fields8(p))[:, 3:]     # noqa: E731
    f8t = lambda p: TMC.pack_fields8(p).detach().numpy()[:, 3:]  # noqa: E731
    for t in range(FRAMES):
        n = jcap[t]["n"]
        means = np.abs(tcap[t]["params"].means3d[:n].numpy()
                       - np.asarray(jcap[t]["params"].means3d)[:n]).max()
        print(f"frame {t}: Gaussians JAX {n}, port {tcap[t]['n']}; means "
              f"{means:.2e} apart")
        for what in ("params", "out"):
            a, b = f8t(tcap[t][what])[:n], f8j(jcap[t][what])[:n]
            print(f"frame {t} mapping {'input ' if what == 'params' else 'output'}"
                  f": logit {band_gap(a[:, 0], b[:, 0])} log-scale "
                  f"{band_gap(a[:, 1], b[:, 1])} rgb {band_gap(a[:, 2:], b[:, 2:])}")
    print("per iteration, from the JAX state: t i | loss jax / port / f64 | "
          "max |accum| diff | logit grad err vs f64 (jax, port; x scale) | "
          "sign flips port-jax, port-f64, jax-f64 (|g64| of the largest) | "
          "step logit share outside, max")
    for t in range(FRAMES):
        n = jcap[t]["n"]
        replay = _lockstep_phase(t, jcap[t])[:n, 3]
        fused = np.asarray(JMC.pack_fields8(jcap[t]["out"]))[:n, 3]
        print(f"frame {t}: the JAX replay step by step vs the JAX engine's "
              f"fused loop, logit {band_gap(replay, fused)}")


def _lockstep_phase(t, c):
    params, kf, stack, cam, cfg = (c[k] for k in ("params", "kf", "stack",
                                                  "cam", "cfg"))
    lr = dict(cfg.lrs)
    lrs8 = jnp.asarray([0.0, 0.0, 0.0, lr["logit_opacities"],
                        lr["log_scales"]] + [lr["rgb_colors"]] * 3,
                       jnp.float32)[None, :]
    chunk = pick_walk_chunk(stack.tab.shape[-1])
    tcam, half = _tcam(cam), torch.tensor(0.5)
    v8 = JMC.pack_fields8(params)
    opt = JO.adam_init(v8)
    for i in range(cfg.num_iters):
        idx = int(jax.random.randint(jax.random.fold_in(c["rng"], i), (), 0,
                                     kf.count))
        ring = int(c["slot_ids"][idx])
        frame = JL.Frame(color=kf.colors[ring], depth=kf.depths[ring])
        kfc = jax.tree.map(lambda x: x[idx], stack)

        def jloss(v):
            r = JMC.render_binned(v, kfc, cam, chunk)
            return JL.loss_from_render(r, frame, cfg.loss_cfg,
                                       jnp.asarray(0.5, v.dtype),
                                       jnp.asarray(False)).loss

        lj, gj = jax.value_and_grad(jloss)(v8)
        accj = np.asarray(JMC.splat_binned(
            v8, kfc.tab, kfc.inv, kfc.quat, kfc.trans, kfc.counts, cam,
            max(chunk, 128), True))
        v8n, optn = JO.adam_step(v8, gj, opt, lrs8, eps=1e-15)
        pk = _port_cache(stack, idx)
        f8 = torch.as_tensor(np.array(v8))

        def tgrad(dtype):
            v = f8.to(dtype).requires_grad_(True)
            fr = TL.Frame(
                color=torch.as_tensor(np.array(frame.color)).to(dtype),
                depth=torch.as_tensor(np.array(frame.depth)).to(dtype))
            out = TL.loss_from_render(TMC.render_binned(v, pk, tcam), fr,
                                      cfg.loss_cfg, half.to(dtype), False)
            g, = torch.autograd.grad(out.loss, (v,))
            return out.loss.item(), g.double().numpy()

        lt, gt = tgrad(torch.float32)
        l64, g64 = tgrad(torch.float64)
        acct = TMC.splat_binned(f8, pk.tab, pk.inv, pk.quat, pk.trans,
                                pk.counts, tcam).detach().numpy()
        state = TO.AdamState(mu=[torch.as_tensor(np.array(opt.mu))],
                             nu=[torch.as_tensor(np.array(opt.nu))],
                             count=int(opt.count))
        (f8n,), _ = TO.adam_step([f8], [torch.as_tensor(gt).float()], state,
                                 [torch.as_tensor(np.array(lrs8))], eps=1e-15)
        a, b, e = gt[:, 3], np.asarray(gj, np.float64)[:, 3], g64[:, 3]
        scale = np.abs(e).max()
        live = (a != 0) | (b != 0) | (e != 0)
        flips = [live & (np.sign(x) != np.sign(y))
                 for x, y in ((a, b), (a, e), (b, e))]
        big = max((np.abs(e[f]).max() for f in flips if f.any()), default=0.0)
        n = c["n"]
        share, mx = band_gap(f8n.numpy()[:n, 3], np.asarray(v8n)[:n, 3])
        print(f"{t} {i} | {float(lj):.8f} / {lt:.8f} / {l64:.8f} | "
              f"{np.abs(acct - accj).max():.2e} of {np.abs(accj).max():.1f} | "
              f"{np.abs(b - e).max() / scale:.2e}, "
              f"{np.abs(a - e).max() / scale:.2e} (scale {scale:.2e}) | "
              f"{' '.join(str(int(f.sum())) for f in flips)} ({big:.1e}) | "
              f"{share:.5f}, {mx:.2e}", flush=True)
        v8, opt = v8n, optn
    return np.asarray(v8)


def binning():
    cfg = _config(tempfile.mkdtemp())
    cfg["mapping"]["num_iters"] = 0
    jeng = JP.VTGaussianSLAM(cfg)
    p = jeng.sections[0].params
    act = np.asarray(jeng.sections[0].active_mask())
    q, tr = np.asarray(jeng.traj.quats[0]), np.asarray(jeng.traj.trans[0])
    cam = jeng.cam

    def proj(means3d, rots, ls, lo, act, q, tr):
        R = JG.quat_to_rotmat(JG.normalize(q))
        return JPR.project_gaussians(means3d @ R.T + tr, rots, jnp.exp(ls),
                                     jax.nn.sigmoid(lo)[:, 0], cam, act)

    args = (p.means3d, p.unnorm_rotations, p.log_scales, p.logit_opacities,
            jnp.asarray(act), jnp.asarray(q), jnp.asarray(tr))
    p_jit = jax.jit(proj)(*args)
    with jax.disable_jit():
        p_eager = proj(*args)
    Rt = TG.quat_to_rotmat(TG.normalize(torch.as_tensor(q)))
    mc = torch.as_tensor(np.asarray(p.means3d)) @ Rt.T + torch.as_tensor(tr)
    p_t = TPR.project_gaussians(
        mc, torch.as_tensor(np.asarray(p.unnorm_rotations)),
        torch.exp(torch.as_tensor(np.asarray(p.log_scales))),
        torch.sigmoid(torch.as_tensor(np.asarray(p.logit_opacities)))[:, 0],
        _tcam(cam), torch.as_tensor(act))
    v = np.asarray(p_eager.valid)
    for name, other in (("JAX op by op", p_eager), ("port", p_t)):
        d = np.abs(np.asarray(p_jit.mean2d, np.float64)
                   - np.asarray(other.mean2d, np.float64))[v]
        print(f"mean2d, JAX jit vs {name}: {int((d > 0).any(-1).sum())} of "
              f"{int(v.sum())} Gaussians differ, largest {d.max():.2e} px")
    print("mean2d, port vs JAX op by op: equal to the bit:",
          np.array_equal(p_t.mean2d.numpy()[v], np.asarray(p_eager.mean2d)[v]))
    x = np.asarray(mc, np.float32)
    zs = np.where(v, x[:, 2], np.float32(1)).astype(np.float32)
    iz = (np.float32(1) / zs).astype(np.float32)
    fxx = (np.float32(cam.fx) * x[:, 0]).astype(np.float32)
    fma = (fxx.astype(np.float64) * iz.astype(np.float64)
           + np.float64(np.float32(cam.cx) - np.float32(0.5))).astype(np.float32)
    print("JAX jit mean2d x == fma(fx * x, 1 / z, cx - 0.5) for",
          int((fma[v] == np.asarray(p_jit.mean2d)[v, 0]).sum()), "of",
          int(v.sum()))
    for select in ("importance", "depth"):
        bj = jax.jit(lambda pr: JB.bin_gaussians(
            pr, 16, 2, 3, 3, 1024, select=select))(p_jit)
        bt = TBN.bin_gaussians(p_t, 16, 2, 3, 3, 1024, select=select)
        cj, ct = np.asarray(bj.counts)[:9], bt.counts.numpy()
        print(f"select={select}: pairs per tile JAX jit {cj.tolist()}, port "
              f"{ct.tolist()}")
        tj, tt = np.asarray(bj.tab)[:9], bt.tab.numpy()
        for tile in range(9):
            sj, st = set(tj[tile, :cj[tile]]), set(tt[tile, :ct[tile]])
            if sj != st:
                print(f"  tile {tile}{' (full)' if cj[tile] == 1024 else ''}:"
                      f" JAX jit only {sorted(int(g) for g in sj - st)}, port "
                      f"only {sorted(int(g) for g in st - sj)}")


def spread(which, seed=1):
    tmp = tempfile.mkdtemp()
    if which == "slice":
        cfg, frames = _config(tmp), FRAMES
        cfg["data"]["synthetic"]["seed"] = seed
        _, (_, _, J), runs = run_jax_slice(cfg)
        _, (_, _, port) = run_port_slice(cfg, slice_draws(cfg))
    else:
        cfg = TB._replica_config(tmp) if which == "replica" else _config(tmp)
        frames = 10 if which == "replica" else 4
        if which == "tum":
            cfg.update(baseframe_every=2, selection_style="tum",
                       overlap_every=1, far_depth_factor=2.0)
            cfg["tpu"].update(track_cache=False, map_binned=False)
            cfg["tracking"]["num_iters"] = 33
        jeng, teng, *_ = TB._run_pair(tmp, cfg, frames)
        J, port = section_fields(jeng, False), section_fields(teng, True)
        runs = TB._jax_spread(cfg, jeng, frames)
    print("port  " + "".join(
        f"section {i}: " + "  ".join(
            f"{f}: share {g[0]:.4f} max {g[1]:.3e}" for f, g in
            ((f, band_gap(port[i][1][f], J[i][1][f])) for f in FIELDS))
        + "\n      " for i in range(len(J))))
    for name, secs in runs.items():
        for i, g in enumerate(secs):
            print(f"{name:6s} section {i}: " + ("Gaussian count differs"
                  if g is None else "  ".join(
                      f"{f}: share {g[f][0]:.4f} max {g[f][1]:.3e}"
                      for f in FIELDS)))


def p2p():
    """test_torch_p2p's metric checks with their margins, per seed."""
    import test_torch_p2p as P2P
    for seed in (0, 1, 2):
        print(f"seed {seed}:")
        P2P.print_margins(P2P.metric_margins(seed))


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "lockstep"
    if mode == "lockstep":
        lockstep()
    elif mode == "binning":
        binning()
    elif mode == "p2p":
        p2p()
    else:
        spread(sys.argv[2], *(int(a) for a in sys.argv[3:]))
