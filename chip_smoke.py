#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (honerf_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run when it fails:

  1. build    every kernel source under honerf_torch/ops/csrc (one nvcc
              per source, all started together);
  2. kernels  each kernel against its plain PyTorch version on the same
              card inputs at the shapes one 4096-ray request gives it
              (K1: 64 and 16 samples a ray, the coarse pass and each
              up-sample step; K2: 128 samples a ray, several passes of
              its chunk loop), full-width hand nets of
              confs/wmask_realhand_hand1.conf with a bf16 trunk, with its
              time, the plain version's time and its bound;
  3. serve    the hand model's novel-view render: one full 230x266 image
              through train.runner.render_full_image and
              train.offline.make_hand_eval_render (64 + 64 samples, 4
              up-sample steps), then a few single-chunk requests.  The
              launch counts are zeroed just before and read just after;
              each kernel must have launched;
  4. check    the served pixels are finite, weight_sum lies in
              [0, 1 + 1e-3], and a patch of rays rendered again on the CPU
              (the kernels' plain versions) agrees with the card's.

Weights are random (geometric init plus seeded noise, so every embedding
column is live).  The last lines of stdout are the card's
`nvidia-smi --query-gpu=name,power.limit` line, a JSON line of per-kernel
numbers, and the result line.  Exits nonzero, printing no result, when
no CUDA device is present or a phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
CONF = os.path.join(ROOT, "confs", "wmask_realhand_hand1.conf")
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
REQUEST_RAYS = 4096
N_REQUESTS = 3
CHECK_RAYS = 128
# Kernel vs plain version on the card.  Both round the same operands to
# bf16 but sum in f32 in another order, so now and then an activation
# rounds to the neighbouring bf16 value (about one point in ten at the
# full width), and that one flip moves the point's outputs by up to a few
# 1e-3 of their range.  So: the median point agrees to f32 noise (1e-4 of
# the range: the color's grad-PE sin(2^l g) amplifies that noise where
# |g| ~ 100), and every point within 1e-2 of the output's range
# (max |plain|).
TOL_MEDIAN = 1e-4
TOL_MAX = 1e-2
# Served rays vs the CPU render of the same rays.  A flip in the ladder
# moves a sample by a fraction of its interval, which moves a pixel (the
# JAX package saw 4.7e-2 per pixel between its bf16 ladder kernel and its
# f32 ladder on a full image, BENCH_NOTES.md); most rays agree closely.
# Both outputs lie in [0, 1], so the tolerances are absolute.
TOL_RENDER_MEDIAN = 1e-3
TOL_RENDER_MAX = 1e-1

def log(*a) -> None:
    print(*a, flush=True)


def gpu_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi failed: {exc}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"


def compare(torch, what: str, got, want, tol_median=TOL_MEDIAN, tol_max=TOL_MAX, scale=None):
    """(ok, max abs error, text): median and max of |got - want| over
    every element against tol_median / tol_max times the output's range
    (max |want| unless given)."""
    err = (got.float() - want.float()).abs().flatten()
    if scale is None:
        scale = max(float(want.abs().max()), 1e-6)
    med, p99 = (float(torch.quantile(err, q)) for q in (0.5, 0.99))
    mx = float(err.max())
    ok = (bool(torch.isfinite(got).all()) and med <= tol_median * scale
          and mx <= tol_max * scale)
    text = (f"{what}: |err| median {med:.2e} p99 {p99:.2e} max {mx:.2e} vs range {scale:.3e} "
            f"(tol median {tol_median:g}, max {tol_max:g} of range){'' if ok else ' FAIL'}")
    return ok, mx, text


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn() over `iters` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def perturb(torch, tree, gen, scale=0.05):
    """Seeded noise on every leaf (geometric init zeroes most embedding
    columns, which would leave them untested)."""
    if isinstance(tree, dict):
        return {k: perturb(torch, v, gen, scale) for k, v in tree.items()}
    if isinstance(tree, list):
        return [perturb(torch, v, gen, scale) for v in tree]
    nz = tree[tree != 0]
    mag = float(nz.abs().mean()) if nz.numel() else 1.0
    noise = torch.randn(tree.shape, generator=gen).to(tree.device)
    return tree + scale * mag * noise


def trunk_dims(cfg, d_out):
    """(in, out) of each SDF trunk layer at its real (unpadded) widths."""
    E, H = cfg.input_width, cfg.d_hidden
    n = len(cfg.dims) - 1
    dims = []
    for l in range(n):
        d_in = E if l == 0 else H + (E if l in cfg.skip_in else 0)
        dims.append((d_in, d_out if l == n - 1 else H))
    return dims


def k1_flops(cfg, n: int) -> float:
    """Matmul operations of the ladder SDF on n points (sdf column only)."""
    return 2.0 * n * sum(i * o for i, o in trunk_dims(cfg, 1))


def k2_flops(cfg, ccfg, n: int) -> float:
    """Trunk forward + u-chain (transposed matmuls, layers n-2..0) + color
    net, on n points."""
    trunk = trunk_dims(cfg, cfg.d_out)
    fwd = sum(i * o for i, o in trunk)
    uchain = sum(cfg.d_hidden * i for i, _ in trunk[:-1])
    cd = ccfg.dims
    color = sum(cd[l] * cd[l + 1] for l in range(len(cd) - 1))
    return 2.0 * n * (fwd + uchain + color)


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops: float, n_bytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, n_bytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import numpy as np

        from honerf_torch.config import load_config
        from honerf_torch.data.synthetic import canonical_hand_joints, posed_hand_example
        from honerf_torch.hand import bone_transforms_from_mano_joints
        from honerf_torch.models.fields import (
            color_config_from_conf,
            init_color_params,
            init_sdf_params,
            init_variance_params,
            pack_fine_color,
            sdf_config_from_conf,
        )
        from honerf_torch.ops import _build
        from honerf_torch.ops import fused_fine_full as FF
        from honerf_torch.ops import fused_hand as FH
        from honerf_torch.render.neus import RenderConfig, pack_hand_field
        from honerf_torch.train.offline import TrainHyper, make_hand_eval_render
        from honerf_torch.train.runner import render_full_image
    except ImportError as exc:
        print(f"chip_smoke: the honerf_torch package is not beside this script: {exc}",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log("torch", torch.__version__, "cuda", torch.version.cuda, "device",
        torch.cuda.get_device_name(0), "count", torch.cuda.device_count())
    failures = []
    rows = {}

    def phase(name, fn):
        t0 = time.time()
        try:
            fn()
            log(f"[{name}] ok in {time.time() - t0:.1f} s")
        except Exception:  # noqa: BLE001 - every phase failure is reported
            failures.append(name)
            log(f"[{name}] FAILED after {time.time() - t0:.1f} s")
            traceback.print_exc(file=sys.stdout)
            sys.stdout.flush()

    # -- 1. build ----------------------------------------------------------
    def build():
        t0 = time.time()
        logs = _build.build_all()
        log(f"built {', '.join(logs)} in {time.time() - t0:.2f} s")
        for name, text in logs.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or "error" in line:
                    log(f"  {name}: {line.strip()}")

    phase("build", build)
    if failures:
        return 1

    # -- configuration and weights ---------------------------------------
    conf = load_config(CONF)
    sdf_cfg = sdf_config_from_conf("hand", conf["model.sdf_network"])._replace(
        trunk_dtype="bf16")
    color_cfg = color_config_from_conf("hand", conf["model.rendering_network"])._replace(
        trunk_dtype="bf16")
    rcfg = RenderConfig.from_conf(conf["model.neus_renderer"])
    tcfg = TrainHyper.from_conf(conf)
    H, W = conf.get_list("dataset.image_size")
    gen = torch.Generator().manual_seed(0)
    params = {
        "sdf": perturb(torch, init_sdf_params(gen, sdf_cfg, device=dev), gen),
        "color": perturb(torch, init_color_params(gen, color_cfg, device=dev), gen),
        "variance": init_variance_params(
            float(conf.get("model.variance_network.init_val", 0.3)), device=dev),
    }
    log(f"conf {os.path.relpath(CONF, ROOT)}: sdf {sdf_cfg.n_layers}x{sdf_cfg.d_hidden} "
        f"skip {sdf_cfg.skip_in} embedding {sdf_cfg.input_width} d_out {sdf_cfg.d_out}; "
        f"color {color_cfg.n_layers}x{color_cfg.d_hidden} in {color_cfg.input_width}; "
        f"render {rcfg.n_samples}+{rcfg.n_importance} up {rcfg.up_sample_steps}; "
        f"trunk bf16; image {H}x{W}")
    joints, cam_R, cam_T = posed_hand_example()
    t_pose = torch.as_tensor(canonical_hand_joints(0.0), device=dev)
    joints_t = torch.as_tensor(joints, device=dev)
    bt_inv = bone_transforms_from_mano_joints(joints_t[None])[0]
    rotT, off, cut = FH.pack_hand_pose(bt_inv, t_pose)
    # points per kernel call of one request: the coarse pass and each
    # up-sample step of the ladder (K1), the fine pass (K2)
    k1_shapes = (("coarse", REQUEST_RAYS * rcfg.n_samples),
                 ("up-sample step", REQUEST_RAYS * (rcfg.n_importance // rcfg.up_sample_steps)))
    k2_points = REQUEST_RAYS * (rcfg.n_samples + rcfg.n_importance)
    rng = np.random.default_rng(0)
    centers = joints[rng.integers(0, 21, k2_points)]
    pts_all = torch.as_tensor(
        (centers + rng.normal(size=(k2_points, 3)) * 0.05).astype(np.float32), device=dev)

    # -- 2. kernels against their plain versions ---------------------------
    def kernel_k1():
        """Both of the ladder's shapes; the numbers of the coarse pass go
        into the kernels line."""
        fused = FH.FusedHandSDF(params["sdf"], sdf_cfg)
        oks, errs = [], []
        start = 0
        for label, n in k1_shapes:
            pts = pts_all[start:start + n]
            start += n
            args = (pts, rotT, off, cut, fused.ws, fused.bs, fused.meta)
            got = FH.fused_hand_sdf(*args)
            want = FH.fused_hand_sdf_plain(*args)
            torch.cuda.synchronize()
            ok, err, text = compare(torch, "sdf", got, want)
            oks.append(ok)
            errs.append(err)
            ms = cuda_ms(torch, lambda: FH.fused_hand_sdf(*args), 10)
            plain_ms = cuda_ms(torch, lambda: FH.fused_hand_sdf_plain(*args), 3)
            n_bytes = nbytes([pts, rotT, off, cut, *fused.ws, *fused.bs]) + 4 * n
            b_ms, b_by = bound(k1_flops(sdf_cfg, n), n_bytes)
            log(f"K1 fused_hand_sdf, {label}: {n} pts ({-(-n // FH.CHUNK)} passes); {text}; "
                f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
            rows.setdefault("K1", dict(name=FH.KERNEL.name, route="cuda",
                                       source=FH.KERNEL.source, replaces=FH.KERNEL.replaces,
                                       points=n, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                       bound_by=b_by, library_ms=None))
        rows["K1"]["max_abs_err"] = max(errs)
        if not all(oks):
            raise AssertionError("K1 disagrees with its plain version")

    def kernel_k2():
        pack = pack_fine_color(params, sdf_cfg, color_cfg)
        pts = pts_all
        args = (pts, rotT, off, cut, pack)
        got = FF.hand_fine_color(*args)
        want = FF.hand_fine_color_plain(*args)
        torch.cuda.synchronize()
        checks = [compare(torch, what, a, b) for what, a, b in zip(("sdf", "g", "color"), got,
                                                                   want)]
        ok = all(c[0] for c in checks)
        ms = cuda_ms(torch, lambda: FF.hand_fine_color(*args), 5)
        plain_ms = cuda_ms(torch, lambda: FF.hand_fine_color_plain(*args), 2)
        n_bytes = (nbytes([pts, rotT, off, cut, *pack.ws, *pack.bs, *pack.cws, *pack.cbs])
                   + 28 * pts.shape[0])
        b_ms, b_by = bound(k2_flops(sdf_cfg, color_cfg, pts.shape[0]), n_bytes)
        log(f"K2 hand_fine_color: {pts.shape[0]} pts ({-(-pts.shape[0] // FF.CHUNK)} passes); "
            f"{'; '.join(c[2] for c in checks)}; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        rows["K2"] = dict(name=FF.KERNEL.name, route="cuda", source=FF.KERNEL.source,
                          replaces=FF.KERNEL.replaces, max_abs_err=max(c[1] for c in checks),
                          points=pts.shape[0], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None)
        if not ok:
            raise AssertionError("K2 disagrees with its plain version")

    phase("kernel K1", kernel_k1)
    phase("kernel K2", kernel_k2)

    # -- 3. serve: full image + requests through the port's entry points --
    render = make_hand_eval_render(sdf_cfg, color_cfg, rcfg, tcfg)
    view = dict(cam_R=torch.as_tensor(cam_R, device=dev),
                cam_T=torch.as_tensor(cam_T, device=dev),
                focal=torch.tensor([3.0, 3.0], device=dev),
                principal=torch.zeros(2, device=dev), joints=joints_t, t_pose_21=t_pose)
    served = {}

    def serve():
        for k in (FH.KERNEL, FF.KERNEL):
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        color, wsum = render_full_image(render, params, view, H, W, chunk=REQUEST_RAYS)
        torch.cuda.synchronize()
        img_s = time.perf_counter() - t0
        from honerf_torch.camera import full_image_ndc_grid

        grid = full_image_ndc_grid(H, W, device=dev)
        req_ms = []
        for i in range(N_REQUESTS):
            rays = grid[i * REQUEST_RAYS:(i + 1) * REQUEST_RAYS]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(params, dict(view, rays_xy=rays))
            torch.cuda.synchronize()
            req_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {"K1": FH.KERNEL.launches, "K2": FF.KERNEL.launches}
        # what the render pays once per parameter snapshot (and each request
        # paid before the packs were kept)
        pack_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pack_hand_field(params, sdf_cfg, color_cfg, fused_ladder=True, fused_fine=True)
            torch.cuda.synchronize()
            pack_ms.append((time.perf_counter() - t0) * 1e3)
        for name, count in launches.items():
            rows.setdefault(name, {})["launches"] = count
        n_rays = H * W
        log(f"serve: image {H}x{W} = {n_rays} rays in {img_s * 1e3:.1f} ms "
            f"({n_rays / img_s:.1f} rays/s, {-(-n_rays // REQUEST_RAYS)} requests of "
            f"<= {REQUEST_RAYS} rays); requests of {REQUEST_RAYS} rays: "
            f"{', '.join(f'{m:.1f}' for m in req_ms)} ms "
            f"({REQUEST_RAYS / (sum(req_ms) / len(req_ms) / 1e3):.1f} rays/s); "
            f"launches {launches}; packing the weights of one snapshot "
            f"{', '.join(f'{m:.2f}' for m in pack_ms)} ms")
        ladder_pts = n_rays * (rcfg.n_samples + rcfg.n_importance
                               - rcfg.n_importance // rcfg.up_sample_steps)
        fine_pts = n_rays * (rcfg.n_samples + rcfg.n_importance)
        for name, pts, flops in (("K1", ladder_pts, k1_flops(sdf_cfg, ladder_pts)),
                                 ("K2", fine_pts, k2_flops(sdf_cfg, color_cfg, fine_pts))):
            row = rows.get(name, {})
            at_rate = (f"{row['ms'] * pts / row['points']:.1f} ms at the kernel phase's rate"
                       if "ms" in row else "kernel phase failed")
            log(f"serve: per image {name} sees {pts} points: {flops / 1e12:.2f} TFLOP, bound "
                f"{flops / PEAK_BF16_FLOPS * 1e3:.2f} ms, {at_rate}")
        served.update(color=color, wsum=wsum, grid=grid)
        if not all(launches.values()):
            raise AssertionError(f"a kernel of the render path did not launch: {launches}")

    phase("serve", serve)

    # -- 4. check the served output ---------------------------------------
    def check():
        color, wsum, grid = served["color"], served["wsum"], served["grid"]
        assert color.shape == (H, W, 3) and wsum.shape == (H, W)
        assert bool(torch.isfinite(color).all()) and bool(torch.isfinite(wsum).all())
        w_min, w_max = float(wsum.min()), float(wsum.max())
        log(f"check: weight_sum min {w_min:.4f} mean {float(wsum.mean()):.4f} max {w_max:.4f}; "
            f"color min {float(color.min()):.4f} max {float(color.max()):.4f}")
        assert 0.0 <= w_min and w_max <= 1.0 + 1e-3, "weight_sum outside [0, 1 + 1e-3]"
        # the rays that meet the most surface, rendered again on the CPU
        idx = torch.argsort(wsum.reshape(-1), descending=True)[:CHECK_RAYS]
        cpu = torch.device("cpu")
        cpu_params = {k: {kk: ([{n: x.to(cpu) for n, x in l.items()} for l in vv]
                               if kk == "layers" else vv.to(cpu)) for kk, vv in v.items()}
                      for k, v in params.items()}
        cpu_view = {k: v.to(cpu) for k, v in view.items()}
        c_ref, w_ref = render(cpu_params, dict(cpu_view, rays_xy=grid[idx].to(cpu)))
        ok = True
        for what, got, want in (("color", color.reshape(-1, 3)[idx].cpu(), c_ref),
                                ("weight_sum", wsum.reshape(-1)[idx].cpu(), w_ref[:, 0])):
            good, _, text = compare(torch, what, got, want, TOL_RENDER_MEDIAN, TOL_RENDER_MAX,
                                   scale=1.0)
            log(f"check: {CHECK_RAYS} rays vs the CPU render (plain versions), {text}")
            ok = ok and good
        log(f"check: their weight_sum {float(w_ref.min()):.4f}..{float(w_ref.max()):.4f}, mean "
            f"color card {float(color.reshape(-1, 3)[idx].mean()):.5f} "
            f"cpu {float(c_ref.mean()):.5f}")
        assert ok, "served pixels disagree with the CPU render"

    # -- 5. where one request's time goes (torch.profiler) ----------------
    def profile():
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        request = dict(view, rays_xy=served["grid"][:REQUEST_RAYS])
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(params, request)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans, groups = [], {}
        for evt in prof.events():
            if evt.device_type != DeviceType.CUDA:
                continue
            tr = evt.time_range
            spans.append((tr.start, tr.end))
            name = evt.name.split("(")[0].replace("honerf::", "")
            if not name.endswith("_kernel") or "honerf" not in evt.name:
                name = "torch: " + name[:60]
            g = groups.setdefault(name, [0.0, 0])
            g[0] += tr.elapsed_us()
            g[1] += 1
        if not spans:
            log("profile: the profiler recorded no device time (not measured)")
            return
        spans.sort()
        busy, end = 0.0, None
        for a, b in spans:
            if end is None or a > end:
                busy += b - a
                end = b
            elif b > end:
                busy += b - end
                end = b
        kern = sum(g[0] for g in groups.values())
        log(f"profile: one request of {REQUEST_RAYS} rays, {wall_us / 1e3:.1f} ms on the host "
            f"clock; device busy {busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%), kernel "
            f"time {kern / 1e3:.1f} ms in {len(spans)} launches")
        for name, (us, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:12]:
            log(f"  {us / 1e3:8.2f} ms {100 * us / kern:5.1f}%  x{cnt:<5d} {name}")

    if "serve" not in failures:
        phase("check", check)
        phase("profile", profile)
    else:
        failures.append("check")

    log(gpu_line())
    order = ("K1", "K2")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    log(json.dumps({"kernels": [{k: rows.get(n, {}).get(k) for k in keys} for n in order]}))
    if failures:
        log(f"chip_smoke: failed phases: {', '.join(failures)}")
        return 1
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
