"""How `correct` is decided: the stages the window ran, followed step by
step by the plain reference (`portbench/reference`) from the program's own
state, and each number beside its limit.

The sampled frames (`session.check_frames`) are the same stages on every
seed, for every scene family: a frame drawn from the seed that is no
section boundary, whose tracking loop is split and followed, and the
first section boundary, which spawns a section and builds the global
binning. For each frame that `Capture` sampled:

- tracking: the reference bins the section at the frame's start pose
  itself, then takes the loop's first three iterations (plain K1, the
  loss, plain K2 through autograd, Adam); compared are each step's loss,
  the first pose gradient (worked out from the program's Adam moment after
  one step) and the pose's change after three steps, per leaf (quaternion,
  translation);
- densification: the reference renders the section at the committed pose
  (plain K4) for the non-presence mask and back-projects the new
  Gaussians from the frame files;
- mapping: the keyframe binnings and the global binning the frame built
  (from the section as mapping found it, at the keyframes' poses), rebuilt
  and compared tile by tile; then the first three iterations on the
  keyframes the program drew, over the rebuilt row tables where the frame
  built them and the program's where earlier frames did (built then from
  earlier states: the program's state), with the global term on a
  boundary frame's first iteration; compared as tracking's;
- a boundary frame's spawn, and frame 0's section (the start), rebuilt
  from the files at the program's pose.

The frames are read again from the sequence files with OpenCV, as the
port's loaders read them. The control is the same reference in TF32: its
float inputs rounded to 10 mantissa bits and TF32 products allowed.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..reference.core import densify as rdens
from ..reference.core import losses as rloss
from ..reference.core import map_cache as rmc
from ..reference.core import track_cache as rtc
from ..reference.core import tracking as rtrack
from ..reference.models import gaussians as rg
from ..reference.models import optimizer as ropt
from ..reference.ops import geometry as rgeo
from ..reference.ops import image as rimg
from ..reference.ops.camera import setup_camera
from ..reference.ops.rasterizer import binning as rbin
from ..reference.ops.rasterizer import cuda_splat as rsplat
from .capture import MAP_STEPS, TRACK_STEPS

B1 = 0.9       # Adam's first-moment decay in both loops


class Sequence:
    """The frames of one written sequence, read as the port's loaders read
    them: colour (H, W, 3) float32 0..255 resized INTER_LINEAR, depth
    (H, W) float32 metres resized INTER_NEAREST."""

    def __init__(self, seq_dir: str, fmt: str, cam: dict):
        self.dir, self.fmt, self.cam = seq_dir, fmt, cam
        if fmt == "replica":
            n = len([f for f in os.listdir(os.path.join(seq_dir, "results"))
                     if f.startswith("frame")])
            self.paths = [(f"results/frame{i:06d}.jpg",
                           f"results/depth{i:06d}.png") for i in range(n)]
        else:
            lines = [ln.split() for ln in open(os.path.join(seq_dir, "rgb.txt"))
                     if not ln.startswith("#")]
            dl = [ln.split() for ln in open(os.path.join(seq_dir, "depth.txt"))
                  if not ln.startswith("#")]
            self.paths = [(a[1], b[1]) for a, b in zip(lines, dl)]

    def read(self, i: int, H: int, W: int):
        import cv2
        c, d = (os.path.join(self.dir, p) for p in self.paths[i])
        color = cv2.cvtColor(cv2.imread(c, cv2.IMREAD_COLOR),
                             cv2.COLOR_BGR2RGB).astype(np.float64)
        color = cv2.resize(color, (W, H), interpolation=cv2.INTER_LINEAR)
        depth = cv2.imread(d, cv2.IMREAD_UNCHANGED).astype(np.int64)
        depth = cv2.resize(depth.astype(np.float64), (W, H),
                           interpolation=cv2.INTER_NEAREST)
        depth = depth / float(self.cam["png_depth_scale"])
        return color.astype(np.float32), depth.astype(np.float32)


class Setting:
    """Sizes and settings the reference needs, from the configuration."""

    def __init__(self, cfg: dict, seq: Sequence, device):
        d = cfg["data"]
        cam = seq.cam
        self.H, self.W = d["desired_image_height"], d["desired_image_width"]
        self.dH = d.get("densification_image_height") or self.H
        self.dW = d.get("densification_image_width") or self.W

        def K_at(h, w):
            return np.array([[cam["fx"] * w / cam["image_width"], 0,
                              cam["cx"] * w / cam["image_width"]],
                             [0, cam["fy"] * h / cam["image_height"],
                              cam["cy"] * h / cam["image_height"]],
                             [0, 0, 1]], np.float32)
        self.cam = setup_camera(self.W, self.H, K_at(self.H, self.W))
        self.dcam = setup_camera(self.dW, self.dH, K_at(self.dH, self.dW))
        self.cfg, self.seq, self.device = cfg, seq, device
        self.tf32 = False

    def f(self, x: torch.Tensor) -> torch.Tensor:
        """A float input as this side reads it (TF32 for the control)."""
        if self.tf32 and x.is_floating_point():
            return rsplat.tf32_round(x)
        return x

    def frame(self, t: int, dense: bool = False):
        """(numpy colour, numpy depth, reference Frame) of frame t."""
        H, W = (self.dH, self.dW) if dense else (self.H, self.W)
        c, d = self.seq.read(t, H, W)
        cd = torch.as_tensor(c, device=self.device)
        dd = torch.as_tensor(d, device=self.device)
        fr = rloss.Frame(color=self.f(cd.permute(2, 0, 1) / 255.0),
                         depth=self.f(dd[None].contiguous()))
        return c, d, fr

    def params(self, p, n: int | None = None):
        """The program's parameters as this side reads them, with the mask
        of the first n rows (None: the parameters alone)."""
        gp = rg.GaussianParams(*[self.f(x.detach()) for x in p.tensors()])
        if n is None:
            return gp
        active = torch.arange(gp.capacity, device=gp.means3d.device) < n
        return gp, active


@contextlib.contextmanager
def _tf32(on: bool):
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def leaf_gap(prog: list, ref: list) -> float:
    """Worst leaf: |norm(program) - norm(reference)| over the larger of the
    reference leaf's norm and the median leaf's."""
    pn = [float(torch.linalg.vector_norm(x.double())) for x in prog]
    rn = [float(torch.linalg.vector_norm(x.double())) for x in ref]
    med = float(np.median(rn))
    return max(abs(a - b) / max(b, med, 1e-30) for a, b in zip(pn, rn))


def leaf_diff(prog: list, ref: list) -> float:
    """Worst leaf: the norm of the difference over the larger of the
    reference leaf's norm and the median leaf's. For the first gradients:
    lower precision turns a gradient more than it scales it, which the gap
    of norms (`leaf_gap`) can miss."""
    rn = [float(torch.linalg.vector_norm(x.double())) for x in ref]
    med = float(np.median(rn))
    return max(float(torch.linalg.vector_norm(a.double() - b.double()))
               / max(r, med, 1e-30) for a, b, r in zip(prog, ref, rn))


def rel_gap(prog: list, ref: list) -> float:
    return max(abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
               for a, b in zip(prog, ref))


def tables_gap(prog: tuple, ref: tuple) -> float:
    """Share of tiles whose row table differs (its count, or a row within
    the reference's count); inf where the tables' shapes differ."""
    (ta, ca), (tb, cb) = prog, ref
    if ta.shape != tb.shape or ca.shape != cb.shape:
        return float("inf")
    live = (torch.arange(tb.shape[1], device=tb.device)[None]
            < cb[:, None].long())
    bad = (ca != cb) | ((ta != tb) & live).any(1)
    return float(bad.double().mean())


def rows_gap(prog: dict, ref: dict) -> float:
    """Largest absolute gap over the rows' fields; inf where the row
    counts differ."""
    gap = 0.0
    for k in ("means", "colors", "log_scales"):
        a, b = prog[k], ref[k]
        if a.shape != b.shape:
            return float("inf")
        if a.numel():
            gap = max(gap, float((a.double() - b.double()).abs().max()))
    return gap


# ----------------------------------------------------------------------
# each stage: what the reference computes from the program's inputs, in
# one form for both sides; `s.tf32` makes it the control
def _far_mask(s: Setting, t: int):
    """The far-depth filter of a non-Replica frame: far_depth_factor x the
    mean of the 30 largest per-frame mean depths of frames 1..t."""
    means = []
    for i in range(1, t + 1):
        d = torch.as_tensor(s.seq.read(i, s.H, s.W)[1], device=s.device)
        means.append(float((d * (d > 0)).sum()
                           / torch.clamp((d > 0).sum(), min=1)))
    means = sorted(means)[-30:]
    thres = s.cfg["far_depth_factor"] * float(np.mean(means))
    d = torch.as_tensor(s.seq.read(t, s.H, s.W)[1], device=s.device)
    return d < thres


def track_ref(s: Setting, t: int, rec: dict) -> dict:
    _, _, frame = s.frame(t)
    params, active = s.params(rec["params"], rec["n"])
    bk = rec["bk"]
    q0, tr0 = s.f(rec["q0"]), s.f(rec["tr0"])
    cache = rtc.build_track_cache(
        params, active, q0, tr0, s.cam, span_cap=bk["span_cap"],
        max_pairs_per_tile=bk["max_pairs_per_tile"], chunk=bk["chunk"],
        tile_pad=rec["tile_pad"], select=rec["select"])
    aux = None
    if s.cfg.get("selection_style", "replica") != "replica":
        aux = _far_mask(s, t)
    tc = rec["tcfg"]
    cfg = rtrack.TrackingConfig(
        num_iters=1, lr_quat=tc.lr_quat, lr_trans=tc.lr_trans, metric="loss",
        loss_cfg=rloss.LossConfig(*tc.loss_cfg), keep_hist=False)
    state = rtrack.init_track_state(q0, tr0, rec["sil0"])
    state.count = rec["count0"]

    def render_fn(quat, trans):
        return rtc.render_cached(cache, quat, trans, s.cam)
    steps = []
    for _ in range(TRACK_STEPS):
        state, _, _ = rtrack.track_loop(render_fn, state, frame, aux, cfg)
        steps.append({k: getattr(state, k) for k in
                      ("quat", "trans", "m", "im_loss", "depth_loss")})
    return _track_out(steps, rec["q0"], rec["tr0"], tc.loss_cfg)


def _track_out(steps: list, q0, tr0, lw) -> dict:
    return dict(
        losses=[lw.im_weight * float(st["im_loss"])
                + lw.depth_weight * float(st["depth_loss"]) for st in steps],
        grad=steps[0]["m"] / (1 - B1),
        change=torch.cat([steps[-1]["quat"], steps[-1]["trans"]])
        - torch.cat([q0, tr0]))


def track_compare(a: dict, b: dict) -> dict:
    return {"track_loss": rel_gap(a["losses"], b["losses"]),
            "track_grad": leaf_diff([a["grad"][:4], a["grad"][4:]],
                                    [b["grad"][:4], b["grad"][4:]]),
            "track_change": leaf_gap([a["change"][:4], a["change"][4:]],
                                     [b["change"][:4], b["change"][4:]])}


def _candidates(s: Setting, idx, d0, color, cam, quat, trans) -> dict:
    dvals = d0.reshape(-1)[idx].astype(np.float32)
    cols = color.reshape(-1, 3)[idx].astype(np.float32) / 255.0
    dev = s.device
    c = rdens.densify_from_pixels(
        quat, trans, s.f(torch.as_tensor(dvals, device=dev)),
        s.f(torch.as_tensor(cols, device=dev)),
        torch.as_tensor(idx, device=dev),
        torch.ones(len(idx), dtype=torch.bool, device=dev), cam)
    k = c.keep
    return dict(means=c.points[k], colors=c.colors[k],
                log_scales=rg._log_scales(c.mean3_sq_dist[k], True))


def _cat(parts: list) -> dict:
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _edge(color):
    return rimg.geometric_edge_mask(color.astype(np.uint8), dilate=True,
                                    RGB=True).astype(bool)


def densify_rows(s: Setting, t: int, rec: dict, mask: torch.Tensor) -> dict:
    """The rows densification appends for a non-presence mask: the frame's
    pixels, then the densification stream's edge pixels."""
    color, depth, _ = s.frame(t)
    quat, trans = s.f(rec["quat"]), s.f(rec["trans"])
    np_np = mask.cpu().numpy()
    parts = [_candidates(s, np.flatnonzero(np_np & (depth > 0)), depth, color,
                         s.cam, quat, trans)]
    dcam = s.dcam
    near = lambda m: rimg.resize_mask_nearest(
        m.astype(np.uint8), dcam.width, dcam.height).astype(bool)
    if (s.dH, s.dW) != (s.H, s.W):
        dcolor, ddepth, _ = s.frame(t, dense=True)
    else:
        dcolor, ddepth = color, depth
    idx_s = np.flatnonzero(near(np_np) & near(_edge(color)) & (ddepth > 0))
    parts.append(_candidates(s, idx_s, ddepth, dcolor, dcam, quat, trans))
    return _cat(parts)


def densify_mask(s: Setting, t: int, rec: dict) -> torch.Tensor:
    _, _, frame = s.frame(t)
    params, active = s.params(rec["params"], rec["n"])
    return rdens.densify_nonpresence(
        params, active, s.f(rec["quat"]), s.f(rec["trans"]), frame, s.cam,
        s.cfg["mapping"]["sil_thres"], tuple(sorted(rec["bk"].items())))


def densify_compare(mask_a, rows_a, mask_b, rows_b) -> dict:
    return {"densify_mask": int((mask_a != mask_b).sum())
            / max(int(mask_b.sum()), 1),
            "densify_rows": rows_gap(rows_a, rows_b)}


def section_rows(s: Setting, t: int, w2c) -> dict:
    """The active rows of the section frame t spawns at pose w2c (None:
    frame 0's, in the camera frame): the frame's pixels, then the
    densification stream's edge pixels."""
    color, _, frame = s.frame(t)
    dmask = rimg.resize_mask_nearest(_edge(color).astype(np.uint8), s.dW,
                                     s.dH).astype(bool)
    if (s.dH, s.dW) != (s.H, s.W):
        _, _, dframe = s.frame(t, dense=True)
    else:
        dframe = frame
    m = torch.as_tensor(dmask, device=s.device)
    if w2c is None:
        parts = [rdens.first_frame_pointcloud(frame, s.cam),
                 rdens.first_frame_pointcloud(dframe, s.dcam, mask=m)]
    else:
        w2c = s.f(w2c)
        parts = [rdens.base_frame_pointcloud(frame, s.cam, w2c),
                 rdens.base_frame_pointcloud(dframe, s.dcam, w2c, mask=m)]
    return _cat([dict(means=p[0][p[3]], colors=p[1][p[3]],
                      log_scales=rg._log_scales(p[2][p[3]], True))
                 for p in parts])


def program_rows(p, n: int) -> dict:
    return dict(means=p.means3d[:n], colors=p.rgb_colors[:n],
                log_scales=p.log_scales[:n])


def _lrs8(lrs: dict, like):
    return torch.tensor(
        [0.0, 0.0, 0.0, lrs.get("logit_opacities", 0.0),
         lrs.get("log_scales", 0.0)] + [lrs.get("rgb_colors", 0.0)] * 3,
        dtype=like.dtype, device=like.device)[None, :]


def _binned_loss(s, v8, tab, counts, quat, trans, frame, loss_cfg):
    """Render fields (N, 8) through a row table at a pose (plain K1), take
    the mapping loss and its gradient in the fields (plain K3, then the
    table's transpose)."""
    tiles_x = -(-s.cam.width // 16)
    R9 = rgeo.quat_to_rotmat(rgeo.normalize(quat)).reshape(9)
    slots = rbin.gather_channels(v8, tab)
    accum = rsplat.splat_forward(slots, R9, trans, counts, s.cam, tiles_x)
    accum.requires_grad_(True)
    with torch.enable_grad():
        r = rtc.accum_result(accum, s.cam, accum.new_zeros(1))
        loss = rloss.loss_from_render(r, frame, loss_cfg,
                                      accum.new_tensor(0.5), False).loss
        (g_acc,) = torch.autograd.grad(loss, (accum,))
    rows = rsplat.splat_backward_vals_rows(slots, R9, trans, counts,
                                           accum.detach(), g_acc.contiguous(),
                                           s.cam, tiles_x)     # (T, mpt, 8)
    live = (torch.arange(tab.shape[1], device=tab.device)[None]
            < counts[:, None].long())
    g8 = torch.zeros_like(v8).index_add_(0, tab[live].long(), rows[live])
    return loss.detach(), g8


def map_tables(s: Setting, r: dict) -> tuple[dict, tuple | None]:
    """The keyframe binnings the frame's mapping phase built, at the poses
    the program registered, and the global binning where the frame built
    it: {slot: (tab, counts)}, and (tab, counts, fixed fields) or None."""
    b = r["built"]
    slots = r["map"]["slots"]
    params, active = s.params(b["params"], b["n"])
    tables = {}
    for k in b["slots"]:
        _, _, quat, trans = slots[k]
        c = rmc.build_kf_cache(
            params, active, s.f(quat), s.f(trans), s.cam,
            span_cap=b["span_cap"], max_pairs_per_tile=b["mpt"],
            tile_pad=b["tile_pad"], select=b["select"])
        tables[k] = (c.tab, c.counts)
    g = r.get("global_built")
    if g is None:
        return tables, None
    gp, gact = s.params(g["params"], g["n"])
    c = rmc.build_global_cache(
        s.params(g["fixed_params"]), g["fixed_active"], gp, gact,
        s.f(g["quat"]), s.f(g["trans"]), s.cam, **g["kw"])
    return tables, (c.tab, c.counts, c.fixed_fields8)


def map_ref(s: Setting, t: int, r: dict) -> dict:
    rec = r["map"]
    tables, gtab = map_tables(s, r)
    mcfg = rec["mcfg"]
    loss_cfg = rloss.LossConfig(*mcfg.loss_cfg)
    f0 = s.f(rec["f8"][0].detach())
    f8 = f0
    lrs8 = _lrs8(dict(mcfg.lrs), f8)
    opt = ropt.adam_init([f8])
    losses, g_first = [], None
    for i in range(MAP_STEPS):
        k = rec["draws"][i]
        ring = rec["slot_ids"][k]
        fid = rec["frame_ids"][ring]
        _, _, frame = s.frame(fid)
        tab, counts, quat, trans = rec["slots"][k]
        tab, counts = tables.get(k, (tab, counts))
        loss, g8 = _binned_loss(s, f8, tab, counts, s.f(quat), s.f(trans),
                                frame, loss_cfg)
        if i == 0 and mcfg.use_global and fid % mcfg.baseframe_every == 0:
            g_tab, g_counts, g_quat, g_trans, g_fixed = rec["gc"]
            fixed = s.f(g_fixed)
            if gtab is not None:
                g_tab, g_counts, fixed = gtab
            lg, gg = _binned_loss(s, torch.cat([fixed, f8]), g_tab, g_counts,
                                  s.f(g_quat), s.f(g_trans), frame, loss_cfg)
            loss, g8 = loss + lg, g8 + gg[fixed.shape[0]:]
        losses.append(float(loss))
        if g_first is None:
            g_first = g8
        (f8,), opt = ropt.adam_step([f8], [g8], opt, [lrs8], eps=ropt.MAP_EPS)
    return dict(losses=losses, grad=g_first, change=f8 - f0, tables=tables,
                gtables=gtab and gtab[:2])


def map_program(r: dict) -> dict:
    rec = r["map"]
    g = rec["gc"] if "global_built" in r else None
    return dict(losses=[sum(float(x) for x in ls)
                        for ls in rec["losses"][:MAP_STEPS]],
                grad=rec["g8"][0], change=rec["f8_after"] - rec["f8"][0],
                tables={k: rec["slots"][k][:2] for k in r["built"]["slots"]},
                gtables=g and g[:2])


MAP_LEAVES = (slice(3, 4), slice(4, 5), slice(5, 8))  # opacity, scale, rgb


def map_compare(a: dict, b: dict) -> dict:
    out = {"map_loss": rel_gap(a["losses"], b["losses"]),
           "map_grad": leaf_diff([a["grad"][:, c] for c in MAP_LEAVES],
                                 [b["grad"][:, c] for c in MAP_LEAVES]),
           "map_change": leaf_gap([a["change"][:, c] for c in MAP_LEAVES],
                                  [b["change"][:, c] for c in MAP_LEAVES]),
           "map_tables": max([tables_gap(a["tables"][k], b["tables"][k])
                              for k in b["tables"]], default=0.0)}
    if b["gtables"] is not None:
        out["global_tables"] = tables_gap(a["gtables"], b["gtables"])
    return out


# ----------------------------------------------------------------------
def numbers(s: Setting, records: dict, start: dict | None,
            control: bool = False) -> dict:
    """Every number over the sampled frames, the worst frame for each: the
    program against the f32 reference, or with `control` the TF32
    reference, in the program's place, against it."""
    out: dict[str, float] = {}

    def put(d):
        for k, v in d.items():
            out[k] = max(out.get(k, 0.0), v)

    @contextlib.contextmanager
    def low():
        s.tf32 = True
        try:
            with _tf32(True):
                yield
        finally:
            s.tf32 = False

    def ref_and_side(fn, *a):
        ref = fn(*a)
        if not control:
            return ref, None
        with low():
            return ref, fn(*a)

    if start is not None:
        ref, ctl = ref_and_side(section_rows, s, 0, None)
        prog = {k: v.to(s.device) for k, v in start["rows"].items()}
        put({"start_rows": rows_gap(ctl if control else prog, ref)})
    for t, rec in sorted(records.items()):
        if "track" in rec and rec["track"]["steps"]:
            tr = rec["track"]
            ref, ctl = ref_and_side(track_ref, s, t, tr)
            prog = ctl if control else _track_out(
                tr["steps"], tr["q0"], tr["tr0"], tr["tcfg"].loss_cfg)
            put(track_compare(prog, ref))
        if "densify" in rec:
            d = rec["densify"]
            mask_r = densify_mask(s, t, d)
            if control:
                with low():
                    mask_c = densify_mask(s, t, d)
                    rows_c = densify_rows(s, t, d, mask_c)
                put(densify_compare(mask_c, rows_c, mask_r,
                                    densify_rows(s, t, d, mask_c)))
            else:
                put(densify_compare(d["mask"], d, mask_r,
                                    densify_rows(s, t, d, d["mask"])))
        if "spawn" in rec:
            sp = rec["spawn"]
            ref, ctl = ref_and_side(section_rows, s, t, sp["w2c"])
            put({"spawn_rows": rows_gap(
                ctl if control else program_rows(sp["params"], sp["n"]), ref)})
        if "map" in rec and rec["map"]["steps"] == MAP_STEPS:
            ref, ctl = ref_and_side(map_ref, s, t, rec)
            put(map_compare(ctl if control else map_program(rec), ref))
    return out
