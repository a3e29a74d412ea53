#!/usr/bin/env python3
"""What the card-side checks of K3 (the fine pass's backward) and K6 (the
trunk + u-chain's backward) catch: each check is read on the sound
kernels and on planted faults.

    python3 check_k3_faults.py [--out readings.json] [--only sound,k6_du_skip_unscaled]

Needs a CUDA device.  Each fault in FAULTS is one small edit of the
backward kernels' sources (honerf_torch/ops/csrc/*.cu[h],
honerf_torch/ops/fused_fine.py and fused_fine_full.py; K3 and K6 share the
trunk's backward launches and epilogues, so a fault there breaks both),
made in a copy of honerf_torch under build/k3_faults/<name>/, whose kernels
build there; a child process runs the checks on that copy.  "sound" is an
unedited copy.  The checks, with the limits they hold:

  kernel  chip_smoke.py's K3 phase on one flagship train step's own
          inputs (chip_smoke.k3_check; 56,448 points; the batch and
          jitter from seed 0, and for the sound kernel seeds 1-5 as
          well): per output |kernel - plain version on the card| /
          |plain| in L2, against TOL_K3_L2;
  kunit   chip_smoke.py's K3 phase on unit cotangents at the same points
          (chip_smoke.k3_unit_check; seed 0, and 0-3 for the sound kernel):
          per output the L2 distance to the card's plain version over the
          limit K3_FACTOR x |plain - plain on the CPU| + K3_REL x |plain|
          (caught above 1);
  unit    tests/test_torch_cuda.py::test_fine_color_bwd_matches_plain (unit
          cotangents, its three cases): per output, the L2 distance to the
          card's plain version over the rule's limit (caught above 1);
  step    chip_smoke.py's train check: one 64-ray step on the card against
          the CPU's (seed 1, and 2-4 for the sound kernel): the worst loss
          term's relative error and the worst gradient leaf's, against
          TOL_TRAIN_LOSS and TOL_TRAIN_GRAD;
  k6      chip_smoke.py's K6 phase: the kernel check above on what one
          flagship 'pallas' train step hands K6 (seed 0, and 0-2 for the
          sound kernel);
  k6unit  chip_smoke.py's K6 phase on unit cotangents at that step's
          embedding (seed 0, and 0-1 for the sound kernel), caught above 1;
  k6step  chip_smoke.py's train check pallas: the step check above with
          train.fused_fine = 'pallas' (seed 1, and 1-2 for the sound kernel).

Prints one summary line per fault and writes every reading to --out
(JSON).  Exits nonzero when the sound kernel fails a check or a fault
passes them all.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "k3_faults")

_CU = "honerf_torch/ops/csrc/fused_fine_bwd.cu"
_CUH = "honerf_torch/ops/csrc/common.cuh"
_K6_CU = "honerf_torch/ops/csrc/fused_trunk.cu"
_TRUNK_PY = "honerf_torch/ops/fused_fine.py"

# name -> (what it breaks, file, text, replacement); the text must occur
# exactly once in the file
FAULTS = {
    "dz_no_ds": (
        "the trunk's dz drops its second-order term ds beta s (1 - s) (K3 and K6)", _CUH,
        "z[i] = (z[i] * p.hscale) * sv[i] + dsv[i] * ((kBeta * sv[i]) * (1.f - sv[i]));",
        "z[i] = (z[i] * p.hscale) * sv[i] + 0.f * dsv[i];"),
    "db_from_bf16": (
        "the trunk's db summed from the bf16 copy of dz (K3 and K6)", _TRUNK_PY,
        "_colsum(lib, dzf[cur], width, m, dbs[l], acc, scratch, stream)",
        "_colsum(lib, dzb[cur].float(), width, m, dbs[l], acc, scratch, stream)"),
    "dw_skip_unscaled": (
        "the skip layer's dW rows of the embedding miss the concat's 1/sqrt2 (K3 and K6)",
        _TRUNK_PY,
        "_tn(lib, e, Ep, Ep, dzb[cur], width, m, dws[l][Hp:], 1, scratch, stream,\n"
        "                    x_scale=INV_SQRT2_BF16)",
        "_tn(lib, e, Ep, Ep, dzb[cur], width, m, dws[l][Hp:], 1, scratch, stream)"),
    "doff_no_v2p": (
        "doff misses the v2p term of dq", _CU,
        "Pr[192 + col] = dq[k];",
        "Pr[192 + col] = dq[k] - 2.f * st.q[k] * dv2p;"),
    "doff_1pct": (
        "doff 1% high", _CU,
        "Pr[192 + col] = dq[k];",
        "Pr[192 + col] = dq[k] * 1.01f;"),
    "color_db_1pct": (
        "the last color layer's db 1% high", _CU,
        "dzf[(size_t)m * ld + c] = v;",
        "dzf[(size_t)m * ld + c] = v * 1.01f;"),
    "fwd_skip_unscaled": (
        "the forward's u-chain misses 1/sqrt2 at the skip (K2, K5, and the recompute of K3 "
        "and K6)", _TRUNK_PY,
        "U=u, split=Hp, hscale=INV_SQRT2,",
        "U=u, split=Hp, hscale=1.0,"),
    "k6_du_skip_unscaled": (
        "K6 takes du unscaled at the skip (bf16(du) for bf16(du / sqrt2))", _K6_CU,
        "du_s[(size_t)m * lddu + c] = __float2bfloat16_rn(v * kInvSqrt2);",
        "du_s[(size_t)m * lddu + c] = __float2bfloat16_rn(v);"),
}
KERNEL_SEEDS = {"sound": (0, 1, 2, 3, 4, 5)}
KUNIT_SEEDS = {"sound": (0, 1, 2, 3)}
STEP_SEEDS = {"sound": (1, 2, 3, 4)}
K6_SEEDS = {"sound": (0, 1, 2)}
K6UNIT_SEEDS = {"sound": (0, 1)}
K6STEP_SEEDS = {"sound": (1, 2)}


def prepare(name: str) -> str:
    """A copy of honerf_torch with the fault's edit; returns its root."""
    root = os.path.join(WORK, name)
    shutil.rmtree(os.path.join(root, "honerf_torch"), ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "honerf_torch"), os.path.join(root, "honerf_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    if name != "sound":
        _, rel, text, repl = FAULTS[name]
        path = os.path.join(root, rel)
        with open(path) as f:
            src = f.read()
        if src.count(text) != 1:
            raise ValueError(f"{name}: the text to edit occurs {src.count(text)} times in {rel}")
        with open(path, "w") as f:
            f.write(src.replace(text, repl))
    return root


def child(name: str, root: str) -> None:
    """Run the three checks on the package under root; print the readings
    as one JSON line."""
    sys.path.insert(0, root)
    import torch

    import honerf_torch

    if os.path.dirname(os.path.abspath(honerf_torch.__file__)) != os.path.join(root,
                                                                                "honerf_torch"):
        raise RuntimeError(f"imported {honerf_torch.__file__}, not the copy under {root}")
    sys.path.insert(1, os.path.join(ROOT, "tests"))
    import chip_smoke as CS
    import test_torch_cuda as TC
    from honerf_torch.ops import _build

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    fs = CS.flagship(torch, dev)
    out = {"fault": name, "kernel": {}, "kunit": {}, "unit": {}, "step": {}, "k6": {},
           "k6unit": {}, "k6step": {}}
    for seed in KERNEL_SEEDS.get(name, (0,)):
        args = CS.step_bwd_inputs(torch, fs, dev, seed)
        _, rows = CS.k3_check(torch, args)
        out["kernel"][str(seed)] = [[r.what, r.l2, r.med, r.mx, r.ok] for r in rows]
        if seed in KUNIT_SEEDS.get(name, (0,)):
            out["kunit"][str(seed)] = [[r.what, r.ratio, r.err, r.floor, r.norm]
                                       for r in CS.k3_unit_check(torch, args)]
    for case, (sdf_kw, n) in TC.BWD_CASES.items():
        out["unit"][case] = TC.bwd_rule_readings(sdf_kw, n, dev)[1]
    for seed in STEP_SEEDS.get(name, (1,)):
        r = CS.train_check_readings(torch, fs, dev, seed)
        out["step"][str(seed)] = {"loss": r.worst_metric, "leaves": r.rel}
    for seed in K6_SEEDS.get(name, (0,)):
        args = CS.step_bwd_inputs(torch, fs, dev, seed, mode="pallas")
        _, rows = CS.k3_check(torch, args, "pallas")
        out["k6"][str(seed)] = [[r.what, r.l2, r.med, r.mx, r.ok] for r in rows]
        if seed in K6UNIT_SEEDS.get(name, (0,)):
            out["k6unit"][str(seed)] = [[r.what, r.ratio, r.err, r.floor, r.norm]
                                        for r in CS.k3_unit_check(torch, args, mode="pallas")]
    for seed in K6STEP_SEEDS.get(name, (1,)):
        r = CS.train_check_readings(torch, fs, dev, seed, mode="pallas")
        out["k6step"][str(seed)] = {"loss": r.worst_metric, "leaves": r.rel}
    print(json.dumps(out))


def judge(CS, res):
    """{check: (caught, text)} of one child's readings."""
    verdict = {}
    for check in ("kernel", "k6"):
        worst, over = {}, []
        for seed, rows in res[check].items():
            for what, l2, med, mx, ok in rows:
                for key, val in (("L2", l2), ("median", med), ("max", mx)):
                    if val > worst.get(key, (-1.0, ""))[0]:
                        worst[key] = (val, f"{what}@{seed}")
                if not ok:
                    over.append(f"{what}@{seed}")
        text = ", ".join(f"{k} {v:.2e} ({w})" for k, (v, w) in worst.items())
        verdict[check] = (bool(over), text + (f"; over: {' '.join(over[:8])}" if over else ""))
    for check in ("kunit", "unit", "k6unit"):
        ratio, where = -1.0, ""
        for case, ratios in res[check].items():
            for what, r, *_ in ratios:
                r = float("inf") if r != r else r
                if r > ratio:
                    ratio, where = r, f"{case} {what}"
        verdict[check] = (ratio > 1.0, f"worst {ratio:.3g} ({where})")
    for check in ("step", "k6step"):
        loss = max(s["loss"] for s in res[check].values())
        leaf = max(max(s["leaves"]) for s in res[check].values())
        loss, leaf = (float("inf") if x != x else x for x in (loss, leaf))
        verdict[check] = (loss > CS.TOL_TRAIN_LOSS or leaf > CS.TOL_TRAIN_GRAD,
                          f"loss {loss:.3g}, leaf {leaf:.3g}")
    return verdict


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(WORK, "readings.json"))
    ap.add_argument("--only", help="comma-separated names (sound and FAULTS) to run")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        child(a.child, a.root)
        return 0
    sys.path.insert(0, ROOT)
    import chip_smoke as CS

    names = ["sound", *FAULTS]
    if a.only:
        names = [n for n in names if n in a.only.split(",")]
    results, bad = {}, []
    for name in names:
        t0 = time.time()
        root = prepare(name)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", name,
                               "--root", root], capture_output=True, text=True, timeout=900)
        secs = time.time() - t0
        if proc.returncode != 0:
            print(f"{name}: the child failed after {secs:.0f} s:\n{proc.stdout[-2000:]}"
                  f"{proc.stderr[-4000:]}", flush=True)
            bad.append(name)
            continue
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        verdict = judge(CS, res)
        res["verdict"] = {k: v[0] for k, v in verdict.items()}
        results[name] = res
        caught = [k for k, (c, _) in verdict.items() if c]
        what = "unedited" if name == "sound" else FAULTS[name][0]
        print(f"{name} ({what}; {secs:.0f} s): "
              + "; ".join(f"{k}: {t}" for k, (_, t) in verdict.items())
              + f" -> caught by: {', '.join(caught) or 'none'}", flush=True)
        if (name == "sound") == bool(caught):
            bad.append(name)
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(results, f, indent=1)
    print(f"readings written to {a.out}")
    if bad:
        print(f"check_k3_faults: not as expected: {', '.join(bad)}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
