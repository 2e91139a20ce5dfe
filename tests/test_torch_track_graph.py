"""The tracking loop's shared step and its CUDA graph (core/tracking.py).

CPU: the bias-correction table holds the floats the loop took on the host
before the table; the loop through `track_step` equals that loop to the
bit where that loop divides as PyTorch divides a card tensor by a host
float; a call split 1+1+1+rest equals the whole call; only the
single-card cached renderer on a card, for two iterations or more, engages
the graph; and a launch captured into a graph counts on each replay. Card
(marked `cuda`): on room0-shaped inputs (680 x 1200, 80 iterations) the
graphed `track_frame_cached` equals the eager loop to the bit, with
either metric and with outlier rejection, and the K1 / K2 launch counters count what the eager
loop counts and the profiler sees run.

This file imports no JAX: on the card,
python -m pytest --noconftest tests/test_torch_track_graph.py -m cuda
"""
import numpy as np
import pytest
import torch

from torch_port_util import POSE_Q, POSE_T, scene_np, torch_cam, torch_params
from vtgaussian_slam_tpu_torch.core import tracking
from vtgaussian_slam_tpu_torch.core.losses import (Frame, LossConfig,
                                                   loss_from_render,
                                                   render_slam)
from vtgaussian_slam_tpu_torch.core.p2p import (make_p2p_target,
                                                point2plane_metric)
from vtgaussian_slam_tpu_torch.core.track_cache import (build_track_cache,
                                                        render_cached)
from vtgaussian_slam_tpu_torch.core.tracking import (TrackingConfig,
                                                     TrackState,
                                                     init_track_state,
                                                     track_frame,
                                                     track_frame_cached,
                                                     track_loop)
from vtgaussian_slam_tpu_torch.ops import geometry as geo
from vtgaussian_slam_tpu_torch.ops.camera import Camera
from vtgaussian_slam_tpu_torch.ops.rasterizer import _build
from vtgaussian_slam_tpu_torch.ops.rasterizer import cuda_splat as CS
from vtgaussian_slam_tpu_torch.parallel.engine import (
    TileGroup, make_track_frame_cached_sharded)

FIELDS = ("quat", "trans", "m", "v", "best_quat", "best_trans",
          "min_metric", "min_loss", "sil_thres", "im_loss", "depth_loss")


def divide(x, bc):
    """x divided by the host float bc, as the loop before the table did."""
    return x / bc


def divide_as_a_card(x, bc):
    """x divided by the host float bc as PyTorch divides a card tensor: a
    product with bc's f32 reciprocal."""
    return x * float(np.float32(1) / np.float32(bc))


def loop_before_the_table(render_fn, state, frame, aux_mask, cfg,
                          p2p_target=None, cam=None, unbias=divide):
    """`track_loop` as it was before `track_step`: the bias corrections as
    host floats (`unbias(x, bc)` divides by them), the loss streams
    written at a host index."""
    if cfg.metric == "p2p":
        K = torch.as_tensor(cam.intrinsics, device=state.quat.device)
    b1, b2, eps = 0.9, 0.999, 1e-8
    dev = state.quat.device
    lr = torch.cat([torch.full((4,), cfg.lr_quat),
                    torch.full((3,), cfg.lr_trans)]).to(dev, state.quat.dtype)
    im_h = torch.zeros((cfg.num_iters,), device=dev)
    d_h = torch.zeros((cfg.num_iters,), device=dev)
    s = state
    for i in range(cfg.num_iters):
        quat = s.quat.detach().requires_grad_(True)
        trans = s.trans.detach().requires_grad_(True)
        r = render_fn(quat, trans)
        out = loss_from_render(r, frame, cfg.loss_cfg, s.sil_thres,
                               s.count == 0, aux_mask)
        gq, gt = torch.autograd.grad(out.loss, (quat, trans))
        with torch.no_grad():
            g = torch.cat([gq, gt])
            count = s.count + 1
            t = torch.tensor(float(count), dtype=torch.float32)
            bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** t)
            bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** t)
            m = b1 * s.m + (1 - b1) * g
            v = b2 * s.v + (1 - b2) * g * g
            upd = lr * unbias(m, bc1) / (torch.sqrt(unbias(v, bc2)) + eps)
            pose = torch.cat([s.quat, s.trans]) - upd
            new_quat, new_trans = pose[:4], pose[4:]
            loss = out.loss.detach()
            metric = loss if cfg.metric == "loss" else point2plane_metric(
                p2p_target, frame.depth, K,
                geo.pose_to_w2c(geo.normalize(new_quat), new_trans),
                method=cfg.p2p_method)
            better = metric < s.min_metric
            lower = loss < s.min_loss
            s = TrackState(
                quat=new_quat, trans=new_trans, m=m, v=v, count=count,
                best_quat=torch.where(better, new_quat, s.best_quat),
                best_trans=torch.where(better, new_trans, s.best_trans),
                min_metric=torch.where(better, metric, s.min_metric),
                min_loss=torch.where(lower, loss, s.min_loss),
                sil_thres=out.sil_thres_out.detach(),
                im_loss=out.im_loss.detach(),
                depth_loss=out.depth_loss.detach())
            im_h[i] = s.im_loss
            d_h[i] = s.depth_loss
    return s, im_h, d_h


def assert_same(a, b, what=""):
    """Two (state, im_hist, depth_hist) results equal to the bit."""
    (sa, ia, da), (sb, ib, db) = a, b
    assert sa.count == sb.count, what
    for name in FIELDS:
        x, y = getattr(sa, name), getattr(sb, name)
        assert torch.equal(x, y), (what, name, x, y)
    for x, y in ((ia, ib), (da, db)):
        assert (x is None) == (y is None), what
        if x is not None:
            assert torch.equal(x, y), (what, (x - y).abs().max())


def loss_cfg(outlier=False):
    return LossConfig(tracking=True, use_sil_for_loss=True,
                      ignore_outlier_depth_loss=outlier, adaptive_sil=True,
                      im_weight=0.5, depth_weight=0.025)


def tcfg(n, metric="loss", outlier=False, keep_hist=True):
    return TrackingConfig(num_iters=n, lr_quat=4e-4, lr_trans=2e-3,
                          metric=metric, loss_cfg=loss_cfg(outlier),
                          keep_hist=keep_hist)


def small_case(device="cpu"):
    """A 40 x 48 scene, its frame rendered at a pose 2 cm away from the
    start pose, the frozen cache at the start, and a p2p target."""
    prm = torch_params(scene_np(500, 1))
    prm = type(prm)(*[x.to(device) for x in prm.tensors()])
    cam = torch_cam()
    active = torch.ones(prm.capacity, dtype=torch.bool, device=device)
    q0 = torch.as_tensor(POSE_Q, device=device)
    t0 = torch.as_tensor(POSE_T, device=device)
    with torch.no_grad():
        r = render_slam(prm, active, q0, t0 + 0.02, cam,
                        {"max_pairs_per_tile": 256})
    frame = Frame(color=r.im.contiguous(), depth=r.depth.contiguous())
    cache = build_track_cache(prm, active, q0, t0, cam, span_cap=3,
                              max_pairs_per_tile=256)
    K = torch.as_tensor(cam.intrinsics, device=device)
    target = make_p2p_target(frame.depth, K,
                             geo.pose_to_w2c(geo.normalize(q0), t0))
    return dict(prm=prm, active=active, cam=cam, q0=q0, t0=t0, frame=frame,
                cache=cache, target=target)


def cached_render_fn(c):
    return lambda q, t: render_cached(c["cache"], q, t, c["cam"])


def test_bias_table_holds_the_host_floats_of_steps_1_to_200():
    tab = tracking.bias_corrections(200)
    assert tab.dtype == torch.float32 and tab.shape == (200, 2)
    for t in range(1, 201):
        tt = torch.tensor(float(t), dtype=torch.float32)
        for j, b in enumerate((0.9, 0.999)):
            old = float(1 - torch.tensor(b, dtype=torch.float32) ** tt)
            assert float(tab[t - 1, j]) == old, (t, b)
    # the step's factors are their f32 reciprocals; a call's slice starts
    # at its state's count, whatever the table's size
    cpu = torch.device("cpu")
    for first, n in ((0, 80), (3, 77), (150, 60), (0, 300)):
        got = tracking.step_factors(cpu, first, n)
        bc = tracking.bias_corrections(first + n)[first:].numpy()
        assert np.array_equal(got.numpy(), np.float32(1) / bc)


@pytest.mark.parametrize("metric", ["loss", "p2p"])
@pytest.mark.parametrize("count0", [0, 3])
def test_step_equals_the_loop_before_the_table(metric, count0):
    """The step multiplies by the table's reciprocals: the loop before the
    table's bits where it divides as on a card (the card test holds the
    division itself there)."""
    c = small_case()
    st = init_track_state(c["q0"], c["t0"], 0.999)
    st.count = count0
    cfg = tcfg(6, metric)
    args = (cached_render_fn(c), st, c["frame"], None, cfg, c["target"],
            c["cam"])
    assert_same(track_loop(*args),
                loop_before_the_table(*args, unbias=divide_as_a_card), metric)


@pytest.mark.parametrize("metric", ["loss", "p2p"])
def test_a_split_call_equals_the_whole_call(metric):
    """1+1+1+rest iterations, the state carried between the calls (the
    benchmark's check splits a frame so), equal the whole call."""
    c = small_case()
    cfg = tcfg(8, metric)
    call = lambda st, n: track_frame_cached(
        c["cache"], st, c["frame"], None, c["cam"],
        cfg._replace(num_iters=n), c["target"])
    whole = call(init_track_state(c["q0"], c["t0"], 0.999), 8)
    st, hists = init_track_state(c["q0"], c["t0"], 0.999), []
    for n in (1, 1, 1, 5):
        st, im_h, d_h = call(st, n)
        hists.append((im_h, d_h))
    split = (st, torch.cat([h[0] for h in hists]),
             torch.cat([h[1] for h in hists]))
    assert_same(whole, split, metric)


def test_the_graph_engages_only_on_the_cached_route_on_a_card(monkeypatch):
    cpu, card = torch.device("cpu"), torch.device("cuda")
    assert not tracking.graph_engages(cpu, 80)
    assert not tracking.graph_engages(card, 1)
    assert tracking.graph_engages(card, 2) and tracking.graph_engages(card, 80)
    c = small_case()
    n0 = tracking.GRAPHED.replays
    track_frame_cached(c["cache"], init_track_state(c["q0"], c["t0"], 0.999),
                       c["frame"], None, c["cam"], tcfg(3))
    assert tracking.GRAPHED.replays == n0      # the CPU: eager

    # what each route does where the predicate would engage
    calls = []

    def graphed(*a, **k):
        calls.append(a[4].num_iters)
        return track_loop(*a, **k)

    monkeypatch.setattr(tracking, "graph_engages", lambda dev, n: n >= 2)
    monkeypatch.setattr(tracking, "track_loop_graphed", graphed)
    st = lambda: init_track_state(c["q0"], c["t0"], 0.999)
    track_frame_cached(c["cache"], st(), c["frame"], None, c["cam"], tcfg(3))
    assert calls == [3]
    track_frame_cached(c["cache"], st(), c["frame"], None, c["cam"], tcfg(1))
    track_frame(c["prm"], c["active"], st(), c["frame"], None, c["cam"],
                tcfg(3)._replace(loss_cfg=loss_cfg()._replace(
                    backend_kwargs=(("max_pairs_per_tile", 256),))))
    sharded = make_track_frame_cached_sharded(TileGroup(rank=0, world=1))
    sharded(c["cache"], st(), c["frame"], None, c["cam"], tcfg(3))
    assert calls == [3]      # one-iteration, generic and sharded: eager


def test_a_captured_launch_counts_on_each_replay(monkeypatch):
    """A wrapper's launch counts where it runs; captured into a graph, it
    counts once per replay; captured outside `CapturedLaunches`, it is
    refused rather than lost."""
    def kernel():
        _build.count_launch(kernel)

    kernel.launches = 0

    class Graph:
        replays = 0

        def replay(self):
            self.replays += 1

    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    kernel()
    assert kernel.launches == 1
    launches, graph = _build.CapturedLaunches(), Graph()
    capturing[0] = True
    with launches:
        kernel()
        kernel()
    capturing[0] = False
    assert kernel.launches == 1      # nothing ran in the capture
    for _ in range(5):
        launches.replay(graph)
    assert (graph.replays, kernel.launches) == (5, 11)
    capturing[0] = True
    with pytest.raises(RuntimeError, match="uncounted"):
        kernel()
    assert kernel.launches == 11 and not _build._CAPTURES


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


ROOM0 = Camera(height=680, width=1200, fx=600.0, fy=600.0, cx=599.5,
               cy=339.5)


def room0_case(dev, n=400_000, seed=0):
    """Replica room0's camera over n isotropic Gaussians filling its view
    at 1-5 m; the frame rendered at a pose 1 cm and ~0.3 deg from the
    start pose, the frozen cache at the start at mpt 512 (span cap 2), and
    the p2p target of a frame 2 cm further on."""
    rng = np.random.default_rng(seed)
    cam = ROOM0
    z = rng.uniform(1.0, 5.0, n)
    u = rng.uniform(-20, cam.width + 20, n)
    v = rng.uniform(-20, cam.height + 20, n)
    means = np.stack([(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z,
                      z], -1)
    rot = np.tile(np.array([[1.0, 0, 0, 0]]), (n, 1))
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)
    from vtgaussian_slam_tpu_torch.models.gaussians import GaussianParams
    prm = GaussianParams(
        means3d=f32(means), rgb_colors=f32(rng.uniform(0, 1, (n, 3))),
        unnorm_rotations=f32(rot),
        logit_opacities=f32(rng.uniform(-1.0, 4.0, (n, 1))),
        log_scales=f32(np.log(rng.uniform(0.004, 0.02, (n, 1)))))
    active = torch.ones(n, dtype=torch.bool, device=dev)
    q0 = f32([1.0, 0.0, 0.0, 0.0])
    t0 = f32([0.0, 0.0, 0.0])
    q_gt = geo.normalize(f32([1.0, 0.002, -0.001, 0.0015]))
    t_gt = f32([0.007, -0.004, 0.006])
    bk = {"max_pairs_per_tile": 512, "span_cap": 2}
    with torch.no_grad():
        r = render_slam(prm, active, q_gt, t_gt, cam, bk)
        r2 = render_slam(prm, active, q_gt, t_gt + 0.02, cam, bk)
    frame = Frame(color=r.im.contiguous(), depth=r.depth.contiguous())
    K = torch.as_tensor(cam.intrinsics, device=dev)
    target = make_p2p_target(r2.depth, K,
                             geo.pose_to_w2c(q_gt, t_gt + 0.02))
    cache = build_track_cache(prm, active, q0, t0, cam, span_cap=2,
                              max_pairs_per_tile=512)
    return dict(cam=cam, q0=q0, t0=t0, frame=frame, cache=cache,
                target=target)


def k1_k2_run(prof) -> tuple[int, int]:
    """The K1 and K2 kernels the profiler saw run on the card."""
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    k1 = sum("splat_fwd_kernel" in n for n in names)
    k2 = sum("splat_bwd_kernel<0>" in n or "splat_bwd_kernelILi0E" in n
             for n in names)
    return k1, k2


def assert_seen_to_run(seen, counted):
    """The launches the wrappers counted against the kernels the profiler
    saw run. The profiler loses a few device records now and then (on an
    H100, one 80-iteration call in twelve lost 160 of its ~21.5k, one K2
    among them), so it bounds the counts from below within a tenth; a
    graph that missed K1 or K2 would show only the eager iteration's."""
    for s, c in zip(seen, counted):
        assert 0.9 * c <= s <= c, (seen, counted)


def run_both(c, cfg, count0=0):
    """{"graphed" | "eager": (the call's result, the K1 and K2 launches it
    counted, the graph iterations it added)}; "profiled": the K1 and K2
    kernels the profiler saw run in the graphed call."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for how in ("graphed", "eager"):
        st = init_track_state(c["q0"], c["t0"], 0.999)
        st.count = count0
        n1 = (CS.splat_forward.launches, CS.splat_backward_pose.launches)
        g0 = tracking.GRAPHED.replays
        if how == "graphed":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                res = track_frame_cached(c["cache"], st, c["frame"], None,
                                         c["cam"], cfg, c["target"])
                torch.cuda.synchronize()
            out["profiled"] = k1_k2_run(prof)
        else:
            res = track_loop(
                lambda q, t: render_cached(c["cache"], q, t, c["cam"]),
                st, c["frame"], None, cfg, c["target"], c["cam"])
        torch.cuda.synchronize()
        out[how] = (res, (CS.splat_forward.launches - n1[0],
                          CS.splat_backward_pose.launches - n1[1]),
                    tracking.GRAPHED.replays - g0)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("metric,outlier", [("loss", False), ("p2p", False),
                                            ("loss", True)])
def test_graphed_loop_equals_the_eager_loop_on_room0_shapes(card, metric,
                                                            outlier):
    c = room0_case(card)
    cfg = tcfg(80, metric, outlier)
    out = run_both(c, cfg)
    (g_res, g_launch, g_iters), (e_res, e_launch, e_iters) = (
        out["graphed"], out["eager"])
    assert_same(g_res, e_res, metric)
    assert g_launch == e_launch == (80, 80), (g_launch, e_launch)
    assert_seen_to_run(out["profiled"], g_launch)
    assert (g_iters, e_iters) == (79, 0)
    # the state the graph leaves is the caller's: a second call from it
    # (count 80, the depth-loss rerun) equals the eager loop's too
    st_g, st_e = g_res[0], e_res[0]
    again_g = track_frame_cached(c["cache"], st_g, c["frame"], None,
                                 c["cam"], cfg, c["target"])
    again_e = track_loop(lambda q, t: render_cached(c["cache"], q, t,
                                                    c["cam"]),
                         st_e, c["frame"], None, cfg, c["target"], c["cam"])
    assert_same(again_g, again_e, metric + " rerun")


@pytest.mark.cuda
def test_graphed_loop_without_streams_and_from_a_split(card):
    """keep_hist off, and the check's 1+1+1+rest split: the rest call
    starts at count 3."""
    c = room0_case(card, seed=1)
    out = run_both(c, tcfg(80, keep_hist=False))
    assert_same(out["graphed"][0], out["eager"][0], "no streams")
    out = run_both(c, tcfg(77), count0=3)
    assert_same(out["graphed"][0], out["eager"][0], "from count 3")
    assert out["graphed"][2] == 76


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["loss", "p2p"])
def test_eager_card_loop_equals_the_loop_before_the_table(card, metric):
    """On the card the step multiplies by the table's f32 reciprocals
    where the loop divided by host floats: the same bits."""
    c = room0_case(card, seed=3)
    cfg = tcfg(30, metric)
    args = (lambda q, t: render_cached(c["cache"], q, t, c["cam"]),
            init_track_state(c["q0"], c["t0"], 0.999), c["frame"], None,
            cfg, c["target"], c["cam"])
    assert_same(track_loop(*args), loop_before_the_table(*args), metric)
    g = torch.randn(1 << 20, device=card) * 1e-3
    fac = tracking.step_factors(card, 0, 200).cpu()
    bc = tracking.bias_corrections(200)
    for t in range(200):
        for j in range(2):
            old = float(bc[t, j])
            assert float(fac[t, j]) == float(np.float32(1) / np.float32(old))
            assert torch.equal(g / old, g * fac[t, j].to(card)), (t, j)
