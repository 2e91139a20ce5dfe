"""What the check reads from the program: for the frames it samples, the
state each stage starts from and what the stage produced, taken inside the
window from the engine's own calls.

The hooks wrap the engine's methods on the instance and, during one call
of a sampled frame, a few names of `core.mapping` and `core.pipeline`. They
change no arithmetic: the tracking loop of the frame named `split` runs as
three one-iteration calls and one call for the rest, which `track_loop`
carries over exactly (its state holds the Adam moments and the iteration
count); the run leaves that frame out of its timed statistics. On the
other sampled frames the hooks only keep references and copy a pose.
What they hold are references to tensors the program made (its sections'
parameters, its mapping fields, gradients and keyframe binnings, with the
inputs the binnings built on this frame were built from) and
device-to-device copies of small ones: poses, losses, Adam moments and the
rows a densification appended.
"""
from __future__ import annotations

import contextlib

import torch

TRACK_STEPS = 3     # tracking iterations the check follows
MAP_STEPS = 3       # mapping iterations the check follows


@contextlib.contextmanager
def patched(module, **repl):
    """Replace module attributes for the length of a block."""
    old = {k: getattr(module, k) for k in repl}
    for k, v in repl.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def _small(state) -> dict:
    """The tracking state's small tensors, copied."""
    return {k: getattr(state, k).detach().clone()
            for k in ("quat", "trans", "m", "im_loss", "depth_loss")}


class Capture:
    """Install on an engine with `install()`; `frame(t)` around each
    `process_frame(t)`. `records[t]` holds what was taken in frame t."""

    def __init__(self, engine, frames, split):
        self.engine = engine
        self.frames = set(frames)
        self.split = split      # the frame whose tracking loop is followed
        self.records: dict[int, dict] = {}
        self.cur: dict | None = None
        self.start = None

    def held_bytes(self) -> int:
        """Device bytes the records keep alive (each storage once)."""
        seen, stack = {}, [self.records, self.start]
        while stack:
            x = stack.pop()
            if isinstance(x, torch.Tensor):
                if x.is_cuda:
                    st = x.untyped_storage()
                    seen[st.data_ptr()] = st.nbytes()
            elif isinstance(x, dict):
                stack.extend(x.values())
            elif isinstance(x, (list, tuple)):
                stack.extend(x)
            elif hasattr(x, "tensors"):
                stack.extend(x.tensors())
        return sum(seen.values())

    def take_start(self):
        """Section 0's rows as frame 0 built them (before any mapping),
        copied to the host during set-up: nothing of it stays on the card
        through the window."""
        sec = self.engine.sections[0]
        n = sec.n_active
        p = sec.params
        self.start = dict(n=n, rows=dict(
            means=p.means3d[:n].cpu(), colors=p.rgb_colors[:n].cpu(),
            log_scales=p.log_scales[:n].cpu()))

    @contextlib.contextmanager
    def frame(self, t: int):
        if t not in self.frames:
            yield
            return
        self.cur = self.records.setdefault(t, {"t": t})
        from vtgaussian_slam_tpu_torch.core import pipeline as pipeline_mod
        try:
            with patched(pipeline_mod, build_global_cache=self._global_hook):
                yield
        finally:
            self.cur = None

    def install(self):
        eng = self.engine
        run_track, track_fn = eng._run_track, eng._track_cached_fn
        densify, spawn = eng._densify, eng._new_base_section
        map_fn = eng._map_binned_fn
        from vtgaussian_slam_tpu_torch.core import mapping as mapping_mod
        from vtgaussian_slam_tpu_torch.core import pipeline as pipeline_mod

        def run_track_hook(sec, state, frame, aux_mask, p2p_t, tcfg):
            r = self.cur
            if r is None or r["t"] != self.split or "track" in r:
                return run_track(sec, state, frame, aux_mask, p2p_t, tcfg)
            r["track"] = dict(
                params=sec.params, n=sec.n_active, q0=state.quat.clone(),
                tr0=state.trans.clone(), sil0=float(state.sil_thres),
                count0=state.count, tcfg=tcfg,
                bk=dict(eng.backend_kwargs), select=eng._bin_select,
                tile_pad=eng.tile_pad, steps=[])
            return run_track(sec, state, frame, aux_mask, p2p_t, tcfg)

        def track_fn_hook(cache, state, frame, aux_mask, cam, tcfg, p2p_t=None):
            r = self.cur
            tr = r and r.get("track")
            if tr is None or tr["steps"] or tcfg.num_iters <= TRACK_STEPS:
                return track_fn(cache, state, frame, aux_mask, cam, tcfg, p2p_t)
            hists = []
            for _ in range(TRACK_STEPS):
                state, im_h, d_h = track_fn(cache, state, frame, aux_mask, cam,
                                            tcfg._replace(num_iters=1), p2p_t)
                tr["steps"].append(_small(state))
                hists.append((im_h, d_h))
            state, im_h, d_h = track_fn(
                cache, state, frame, aux_mask, cam,
                tcfg._replace(num_iters=tcfg.num_iters - TRACK_STEPS), p2p_t)
            hists.append((im_h, d_h))
            if im_h is None:
                return state, None, None
            return (state, torch.cat([h[0] for h in hists]),
                    torch.cat([h[1] for h in hists]))

        def densify_hook(t, frame, edge_mask_np, color_np, depth_np):
            r = self.cur
            if r is None:
                return densify(t, frame, edge_mask_np, color_np, depth_np)
            bf = t // eng.bfe
            sec = eng._sec(bf)
            got = {}

            def nonpresence(*a, **k):
                got["mask"] = real_np(*a, **k)
                return got["mask"]
            real_np = pipeline_mod.densify_nonpresence
            d = dict(params=sec.params, n=sec.n_active,
                     quat=eng.traj.quats[t].clone(),
                     trans=eng.traj.trans[t].clone(),
                     bk=dict(eng.backend_kwargs))
            with patched(pipeline_mod, densify_nonpresence=nonpresence):
                n_new = densify(t, frame, edge_mask_np, color_np, depth_np)
            new = eng.sections[bf]
            rows = slice(d["n"], d["n"] + n_new)
            d.update(mask=got["mask"], n_new=n_new,
                     means=new.params.means3d[rows].clone(),
                     colors=new.params.rgb_colors[rows].clone(),
                     log_scales=new.params.log_scales[rows].clone())
            r["densify"] = d
            return n_new

        def spawn_hook(t, frame, color_np):
            out = spawn(t, frame, color_np)
            r = self.cur
            if r is not None:
                sec = eng.sections[-1]
                r["spawn"] = dict(params=sec.params, n=sec.n_active,
                                  w2c=eng._traj_w2c(t).clone())
            return out

        store = eng.map_store
        store_update = store.update

        def store_update_hook(params, active, n_active, ring_idx, quat, trans,
                              cam, span_cap, mpt, W):
            out = store_update(params, active, n_active, ring_idx, quat,
                               trans, cam, span_cap, mpt, W)
            r = self.cur
            if r is not None and "built" not in r:
                # the keyframe binnings this mapping phase built, from the
                # section as it stands now
                r["built"] = dict(
                    params=params, n=n_active, span_cap=span_cap, mpt=mpt,
                    tile_pad=store.tile_pad, select=store.select,
                    slots=[i for i, tick in enumerate(store.built_tick)
                           if tick == store.tick])
            return out

        real_global = pipeline_mod.build_global_cache

        def global_cache_hook(fixed_params, fixed_active, params, active,
                              cam_quat, cam_trans, cam, **kw):
            r = self.cur
            if r is not None:
                # the global binning built on this frame, and its inputs:
                # the frozen sections' rows and the trainable section
                r["global_built"] = dict(
                    fixed_params=fixed_params, fixed_active=fixed_active,
                    params=params, n=r["built"]["n"], quat=cam_quat,
                    trans=cam_trans, kw=kw)
            return real_global(fixed_params, fixed_active, params, active,
                               cam_quat, cam_trans, cam, **kw)

        def map_fn_hook(params, kf, slots, slot_ids, cam, mcfg, draws=None,
                        generator=None, gc=None):
            r = self.cur
            if r is None or "map" in r:
                return map_fn(params, kf, slots, slot_ids, cam, mcfg,
                              draws=draws, generator=generator, gc=gc)
            m = dict(slots=list(slots), slot_ids=list(slot_ids),
                     frame_ids=list(kf.frame_ids), mcfg=mcfg,
                     gc=gc, draws=[], losses=[[]], f8=[], g8=[], steps=0)
            r["map"] = m
            real_draw, real_loss = mapping_mod._draw, mapping_mod.loss_from_render
            real_adam = mapping_mod.adam_step

            def draw(i, count, dr, gen):
                k = real_draw(i, count, dr, gen)
                if i < MAP_STEPS:
                    m["draws"].append(k)
                return k

            def loss(*a, **k):
                out = real_loss(*a, **k)
                if m["steps"] < MAP_STEPS:
                    m["losses"][-1].append(out.loss.detach())
                return out

            def adam(params_, grads, opt, lrs, **k):
                new, st = real_adam(params_, grads, opt, lrs, **k)
                if m["steps"] < MAP_STEPS:
                    if m["steps"] == 0:
                        m["f8"].append(params_[0])
                        m["g8"].append(grads[0])
                    m["steps"] += 1
                    m["losses"].append([])
                    if m["steps"] == MAP_STEPS:
                        m["f8_after"] = new[0]
                return new, st

            with patched(mapping_mod, _draw=draw, loss_from_render=loss,
                         adam_step=adam):
                out = map_fn(params, kf, slots, slot_ids, cam, mcfg,
                             draws=draws, generator=generator, gc=gc)
            # keep what the reference reads: the drawn keyframes' row
            # tables and poses, the global binning's, the first fields,
            # the first gradient and the fields after the last step
            built = r.get("built", {}).get("slots", [])
            m["slots"] = {k: (m["slots"][k].tab, m["slots"][k].counts,
                              m["slots"][k].quat, m["slots"][k].trans)
                          for k in set(m["draws"]) | set(built)}
            if gc is not None:
                m["gc"] = (gc.tab, gc.counts, gc.quat, gc.trans,
                           gc.fixed_fields8)
            m["f8"], m["g8"] = m["f8"][:1], m["g8"][:1]
            return out

        eng._run_track = run_track_hook
        eng._track_cached_fn = track_fn_hook
        eng._densify = densify_hook
        eng._new_base_section = spawn_hook
        eng._map_binned_fn = map_fn_hook
        store.update = store_update_hook
        self._global_hook = global_cache_hook
