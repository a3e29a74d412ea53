#!/usr/bin/env python3
"""What the card-side checks of K3 (the fine pass's backward), K6 (the
trunk + u-chain's backward), their f32 modes, the fit step, the per-point
kernels, K4, the padded-row copy, the pack of e and the pose sums catch:
each check is read on the sound kernels and on planted faults.

    python3 check_k3_faults.py [--out readings.json] [--only sound,k6_du_skip_unscaled]
                               [--groups f32,fit]

Needs a CUDA device.  Each fault in FAULTS is one small edit of the
kernels' sources (honerf_torch/ops/csrc/*.cu[h],
honerf_torch/ops/fused_fine.py and fused_fine_full.py; K3 and K6 share the
trunk's backward launches and epilogues, so a fault there breaks both),
made in a copy of honerf_torch under build/k3_faults/<name>/, whose kernels
build there; a child process runs the checks on that copy.  "sound" is an
unedited copy and reads every check; a fault reads the checks of its
groups (bf16: the first eight below, f32: the next six, fit: the next
six, perpoint: the next five, trunk: the next two, trunkbwd32: tbwd32
with f32k3, f32k6, fitk3 and fitk6, trunkdw32: tdw32 with f32k3 and
f32k6, color32: color32 with f32k3, f32k6, fitk3 and fitk6, color16: color16
with kernel at seed 0, tbwd16: tbwd16 with kernel and k6 at seed 0, video:
the last;
--groups reads only the named groups, and skips the faults with none of
them).
The checks, with the
limits they hold:

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
          train.fused_fine = 'pallas' (seed 1, and 1-2 for the sound kernel);
  bgemm   chip_smoke.py's bf16 GEMMs phase (chip_smoke.bf16_gemm_readings):
          gemm_kernel and gemm_tn_kernel alone at a bf16 pass's shapes,
          |kernel - f64| / |f64| in L2 against TOL_GEMM_BF16_L2 and the
          same bits on a rerun;
  gemm    chip_smoke.py's f32 GEMMs phase (chip_smoke.f32_gemm_readings):
          gemm_f32_kernel and gemm_tn_f32_kernel alone at an f32 pass's
          shapes, |kernel - f64| / |f64| in L2 against TOL_GEMM_F32_L2 and
          the same bits on a rerun;
  f32k3   chip_smoke.py's kernel K3 f32 phase (chip_smoke.f32_bwd_check):
          K3 f32 with dW on what one flagship f32 'full' step hands it
          (56,448 points, two passes), every output against TOL_F32 in L2
          (seed 0, and 0-1 for the sound kernel);
  f32nc   chip_smoke.py's kernel K2/K3 f32 no-color phase: K2 f32 without
          the color net (out, g, e against TOL_F32 of the range) and K3 f32
          without it, with dW, under the rule above (seed 0);
  f32k6   chip_smoke.py's kernel K5/K6 f32 phase: K5 f32 and K6 f32 with dW
          (seed 0);
  f32step chip_smoke.py's train check f32: one 64-ray f32 step per mode
          ('full', 'full_nocolor', 'pallas') against the CPU's, against
          TOL_TRAIN_F32_LOSS and TOL_TRAIN_F32_GRAD (seed 1);
  f32unit tests/test_torch_cuda.py's f32 backward rule on unit cotangents
          (f32_bwd_rule_readings: K3 with and without the color net, K6,
          at F32_BWD_CASES): L2 over TOL_F32 of the norm (caught above 1);
  fitf64  chip_smoke.py's fit check against the CPU's f64 step (seed 2):
          the worst ratio to its limit, of the whole step and of the
          render terms' hand-pose gradients (caught above 1);
  fitgrid the fit check on rays that meet the hand head on, no K1: the
          card's step against the CPU's f32 step in each fine-pass mode,
          the whole pose gradient against TOL_FIT_HEAD_ON and the render
          terms' hand-pose gradients against TOL_FIT_RENDER (seed 2);
  fitk1   the same rays with K1 (seeds 2-4 for the sound kernel, 2 for a
          fault): the f64 rule of fitf64 at the card's samples, and K1 at
          the step's own ladder points against its plain version (median
          and max of the range against TOL_MEDIAN, TOL_MAX);
  fitk3   chip_smoke.py's kernel K3 f32 frozen phase: the frozen K3 f32 on
          a fit step's own inputs and on unit cotangents at its points
          (chip_smoke.f32_bwd_check), dp, drotT, doff against TOL_F32;
  fitnc   chip_smoke.py's kernel fit modes f32 phase, 'full_nocolor': K2
          f32 without the color net at a '12' fit step's points (out, g, e
          against TOL_F32 of the range) and the frozen K3 f32 without it on
          the step's cotangents and on unit cotangents, L2 against TOL_F32;
  fitk6   the same phase, 'pallas': K5 f32 (out, u) and the frozen K6 f32;
  ppt     chip_smoke.py's per-point kernels phase (chip_smoke.perpoint_readings,
          seed_readings, bwdrev_readings) at perpoint_calls, seed_calls and
          bwdrev_calls: hand_embed_kernel against embed_plain (the kernel
          rule, the padding exactly 0), colsum_partial_kernel bit for bit
          against colsum_ordered_plain, within TOL_COLSUM_F64 of f64 and the
          same bits on a rerun, uchain_seed_kernel bit for bit against
          uchain_seed_plain and torch.mul, fine_bwd_rev_kernel against
          fine_bwd_rev_plain (the kernel rule; f32 TOL_F32; padding 0, dz
          exact) (the perpoint group);
  k4      K4 (obj_sdf_fused_kernel) against fused_obj_sdf_plain on the
          object conf's net at 1, 63, 64, 65, 1,001 and 65,613 points, the
          kernel rule (max |err| / range; the perpoint group);
  copy    copy_cols_kernel at chip_smoke.copy_calls (a 'full_nocolor'
          step's four calls and a 'pallas' step's), bit for bit against
          copy_cols_plain and copy_, the rest of the destination untouched
          (the perpoint group);
  pack    trunk_pack_e_kernel at chip_smoke.pack_calls (a 'pallas' step's,
          an f32 step's, a request's and a fit step's calls) and
          ragged_pack_pose_calls' (1, 7, 70,001 rows at e offsets of 4,
          12, 8 bytes), bit for bit against trunk_pack_e_plain and copy_
          into a NaN-filled eb (the perpoint group);
  pose    pose_sum_kernel at chip_smoke.pose_calls (a bf16 'full' step's,
          an f32 step's, a fit step's) and the ragged 1, 511, 70,001 rows,
          bit for bit against pose_sum_ordered_plain, on a rerun, within
          TOL_COLSUM_F64 of f64 (the perpoint group);
  trunk   the bf16 trunk's two fused kernels (hand_trunk_fwd_kernel,
          hand_uchain_kernel) at chip_smoke.ragged_trunk_calls (1 to
          65,613 points, every output mode: K1's sdf column, z with and
          without keep, the recompute's rows; u with and without keep, the
          recompute's t and c rows) against trunk_fwd_plain /
          trunk_uchain_plain (the kernel rule on every output, a rerun's
          bits), K1 through fused_hand_sdf at 1 to 65,613 points against
          fused_hand_sdf_plain, and the forward's reciprocal against
          __frcp_rn at every f32 in [1, 2] (the trunk group);
  trunk32 the f32 trunk's pair (hand_trunk_fwd_f32_kernel,
          hand_uchain_f32_kernel) at chip_smoke.ragged_trunk32_pairs (1 to
          65,613 points; K2's and K5's outputs, K3's and K6's recompute)
          (chip_smoke.trunk32_readings): the worst of two ratios, each
          caught above 1: the f32 rule's (median and max of every output
          over TOL_F32 of its range, against the plain versions) and the
          L2 to f64 over TOL_TRUNK32_VS_SPLIT x the split launches' (the
          trunk group);
  tbwd32  the f32 trunk's backward pair (hand_trunk_ut_f32_kernel,
          hand_trunk_dz_f32_kernel) through fused_fine.cuda_trunk_backward
          at chip_smoke.ragged_trunk_bwd32_calls (1 to 65,613 points, with
          and without dW) (chip_smoke.trunk_bwd32_readings): the worst of
          the f32 rule's ratio (every output against the plain versions)
          and the L2 to f64 over TOL_TRUNK32_VS_SPLIT x the split launches',
          each caught above 1 (the trunkbwd32 group, with f32k3, f32k6,
          fitk3 and fitk6);
  tdw32   the f32 weight gradients' launch (trunk_dw_f32_kernel) through
          fused_fine.trunk_dw at chip_smoke.ragged_trunk_dw32_calls (1 to
          65,613 points, with and without K3's color rows) and at an f32
          pass's 28,288 (chip_smoke.trunk_dw32_readings): the worst of the
          f32 rule's ratio (every dW and db against trunk_dw_plain) and the
          L2 to f64 over TOL_TRUNK32_VS_SPLIT x the split sequence's, each
          caught above 1 (the trunkdw32 group, with f32k3 and f32k6);
  color32 the f32 color net's two kernels (color_fwd_f32_kernel,
          color_bwd_f32_kernel) through fused_fine_full.color_fwd_f32 /
          color_bwd_f32 at chip_smoke.ragged_color32_calls (1 to 65,613
          points, each output mode) and at an f32 pass's 28,224
          (chip_smoke.color32_readings): the worst of the f32 rule's ratio
          (every output against the plain versions) and the L2 to f64 over
          TOL_TRUNK32_VS_SPLIT x the split launches', each caught above 1
          (the color32 group, with f32k3, f32k6, fitk3 and fitk6);
  color16 the bf16 color net's two kernels (color_fwd_kernel,
          color_bwd_kernel) through fused_fine_full.color_fwd / color_bwd
          at chip_smoke.ragged_color16_calls (1 to 65,613 points, each
          output mode) and at a bf16 pass's 56,448
          (chip_smoke.color16_readings): the kernel rule's ratio (every
          output against the plain versions: median over TOL_MEDIAN, max
          over TOL_MAX of the range), caught above 1 or where a rerun's
          bits or the split launches' bits move beyond f64's 1.25x (the
          color16 group, with kernel at seed 0);
  tbwd16  the bf16 trunk's backward pair (hand_trunk_ut_kernel,
          hand_trunk_dz_kernel) at chip_smoke.ragged_trunk_bwd32_calls (1
          to 65,613 points, with and without dW) and at a bf16 pass's
          56,448 (chip_smoke.trunk_bwd16_readings): the kernel rule's
          ratio (each chain's outputs against the plain versions: median
          over TOL_MEDIAN, max over TOL_MAX of the range), caught above 1
          or where an output of cuda_trunk_backward is not finite, a
          rerun's bits move or its SHA-256 is not the split launches' (the
          tbwd16 group, with kernel and k6 at seed 0);
  video   chip_smoke.py's video check (chip_smoke.video_check_readings):
          two video steps ('1234', windows [0, 3] then [1, 4]) on the card
          against the CPU at the card's ladder samples, every metric and
          table gradient under the fit check's f64 rule, the six gradients
          as one within TOL_FIT_HEAD_ON and every table's update within
          TOL_VIDEO_TABLES; the first step's color and mask losses
          against the single fit loss of each frame on its own
          (TOL_FIT_HEAD_ON); the tables after both steps against f64 Adam
          on whole tables from the recorded gradients (TOL_VIDEO_TABLES);
          caught above 1 of its limit (the video group).

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

_TRUNK_CUH = "honerf_torch/ops/csrc/trunk.cuh"
_WGMMA_CUH = "honerf_torch/ops/csrc/wgmma.cuh"
_FULL_PY = "honerf_torch/ops/fused_fine_full.py"
_K1_PY = "honerf_torch/ops/fused_hand.py"
_SDF_CU = "honerf_torch/ops/csrc/fused_sdf.cu"
_FT_CU = "honerf_torch/ops/csrc/fused_trunk.cu"
_TF_CU = "honerf_torch/ops/csrc/trunk_fused.cu"
_T32_CU = "honerf_torch/ops/csrc/trunk_fused_f32.cu"
_TF32_CUH = "honerf_torch/ops/csrc/tf32.cuh"
_TB32_CU = "honerf_torch/ops/csrc/trunk_bwd_f32.cu"
_TDW32_CU = "honerf_torch/ops/csrc/trunk_dw_f32.cu"
_CF32_CU = "honerf_torch/ops/csrc/color_fused_f32.cu"
_CF16_CU = "honerf_torch/ops/csrc/color_fused.cu"
_TB16_CU = "honerf_torch/ops/csrc/trunk_bwd.cu"
_VIDEO_PY = "honerf_torch/fit/video.py"

# name -> (what it breaks, file, text, replacement, groups of checks it is
# read by); the text must occur exactly once in the file
FAULTS = {
    "dz_no_ds": (
        "the trunk's dz drops its second-order term ds beta s (1 - s) (K3 and K6)", _CUH,
        "z[i] = (z[i] * p.hscale) * sv[i] + dsv[i] * ((kBeta * sv[i]) * (1.f - sv[i]));",
        "z[i] = (z[i] * p.hscale) * sv[i] + 0.f * dsv[i];", ("bf16",)),
    "db_from_bf16": (
        "the trunk's db summed from the bf16 copy of dz (K3 and K6)", _TRUNK_PY,
        "_colsum(lib, Zf, width, m, dbs[l], acc, scratch, stream)",
        "_colsum(lib, Zb.float(), width, m, dbs[l], acc, scratch, stream)", ("bf16",)),
    "dw_skip_unscaled": (
        "the skip layer's dW rows of the embedding miss the concat's 1/sqrt2 (K3 and K6)",
        _TRUNK_PY,
        "_tn(lib, e, Ep, Ep, Zb, width, m, dws[l][Hp:], 1, scratch, stream,\n"
        "            x_scale=skip_scale)",
        "_tn(lib, e, Ep, Ep, Zb, width, m, dws[l][Hp:], 1, scratch, stream)", ("bf16",)),
    "doff_no_v2p": (
        "doff misses the v2p term of dq", _CU,
        "Pr[192 + col] = dq[k];",
        "Pr[192 + col] = dq[k] - 2.f * st.q[k] * dv2p;", ("bf16", "fit")),
    "doff_1pct": (
        "doff 1% high", _CU,
        "Pr[192 + col] = dq[k];",
        "Pr[192 + col] = dq[k] * 1.01f;", ("bf16", "fit")),
    "color_db_1pct": (
        "the last color layer's db 1% high", _CU,
        "dzf[(size_t)m * ld + c] = v;",
        "dzf[(size_t)m * ld + c] = v * 1.01f;", ("bf16",)),
    "fwd_skip_unscaled": (
        "the bf16 u-chain (hand_uchain_kernel) misses 1/sqrt2 on c at the skip (K2, K5, and "
        "the recompute of K3 and K6)", _TF_CU,
        "const float hscale = l == p.skip ? p.hscale : 1.f;",
        "const float hscale = 1.f;", ("bf16", "trunk")),
    "k6_du_skip_unscaled": (
        "K6 takes du unscaled at the skip (bf16(du) for bf16(du / sqrt2))", _K6_CU,
        "du_s[(size_t)m * lddu + c] = from_f32<T>(v * kInvSqrt2);",
        "du_s[(size_t)m * lddu + c] = from_f32<T>(sizeof(T) == 2 ? v : v * kInvSqrt2);",
        ("bf16",)),
    "wgmma_no_scale": (
        "the bf16 GEMMs' mainloop drops the skip concat's scale (a_scale in every skip layer's "
        "product, x_scale in its dW)", _WGMMA_CUH,
        "if (scale != 0.f) {  // the skip concat",
        "if (false) {  // the skip concat", ("bf16",)),
    "wgmma_skip_last_k": (
        "gemm_kernel's consumers skip the products of each tile's last K stage (they wait for "
        "it and free it: the ring still turns)", _WGMMA_CUH,
        "        launch<kTN>(acc, ring, c, stage, false);",
        "        if (k + 1 < w.steps) launch<kTN>(acc, ring, c, stage, false);",
        ("bf16",)),
    "f32_tn_no_xscale": (
        "the f32 weight gradients' launch drops x's scale (the skip rows' 1/sqrt2 in the skip "
        "layer's dW)", _TDW32_CU,
        "const float scale = (x >> 11) & 1 ? p.xscale : 1.f;", "const float scale = 1.f;",
        ("f32", "trunkdw32")),
    "f32_gemm_1xtf32": (
        "both f32 GEMMs drop the two correction products of 3xTF32 (one TF32 product)", _CUH,
        "  for (int j = 0; j < 4; ++j) mma_tf32(c[j], a_small, b_big[j]);   // small . big\n"
        "#pragma unroll\n"
        "  for (int j = 0; j < 4; ++j) mma_tf32(c[j], a_big, b_small[j]);   // big . small\n",
        "", ("f32", "fit")),
    "k6_f32_du_skip_unscaled": (
        "K6 f32 takes du unscaled at the skip (du for du / sqrt2)", _K6_CU,
        "du_s[(size_t)m * lddu + c] = from_f32<T>(v * kInvSqrt2);",
        "du_s[(size_t)m * lddu + c] = from_f32<T>(sizeof(T) == 4 ? v : v * kInvSqrt2);",
        ("f32", "fit")),
    "f32_nocolor_de_block": (
        "K3 f32 without the color net drops the cotangent on e's last 64 columns", _FULL_PY,
        "FT.copy_cols(blib, de_ext, m, E, dx, stream)",
        "FT.copy_cols(blib, de_ext, m, E - 64 if f32_mode else E, dx, stream)",
        ("f32", "fit")),
    "f32_dw_no_acc": (
        "the f32 weight gradients' launch does not accumulate across point passes (each pass "
        "overwrites dW and db)", _TDW32_CU, "    if (p.acc) {", "    if (false) {",
        ("f32", "trunkdw32")),
    "k1_ladder_bias": (
        "K1 (the fit's hand ladder) returns sdf + 5e-3", _K1_PY,
        "FT.trunk_fwd(e, m, ws, bs, tm, sdf=out[s:], stream=stream)",
        "FT.trunk_fwd(e, m, ws, bs, tm, sdf=out[s:], stream=stream)\n"
        "        out[s:s + m] += 5e-3", ("fit", "trunk")),
    "drotT_no_dg_term": (
        "K3's drotT misses its dg^T f_q term (every mode, the fit's frozen f32 one included)",
        _CU,
        "Pr[a * 64 + col] = t[a] * ch.f_q[k] + p[a] * dq[k];",
        "Pr[a * 64 + col] = p[a] * dq[k];", ("fit",)),
    "emb_tail_row": (
        "the embedding's ragged last tile leaves its last row unstored", _CUH,
        "bulk_store(e + (size_t)p0 * lde, buf, (unsigned)(rows * lde * sizeof(T)));",
        "bulk_store(e + (size_t)p0 * lde, buf, (unsigned)((rows - (rows < P)) * lde * "
        "sizeof(T)));", ("bf16", "perpoint")),
    "emb_no_pad": (
        "the embedding's zero padding is never written (the tiles' padding columns keep what "
        "shared memory held)", _CUH,
        "for (int i = tid; i < 2 * P * pad; i += EMB_THREADS)",
        "for (int i = tid; i < 0; i += EMB_THREADS)", ("bf16", "perpoint")),
    "colsum_drop_acc": (
        "the column sum drops a thread's fourth row accumulator (db of K3 and K6)", _TRUNK_CUH,
        "red[warp][lane] = add4(add4(a[0], a[1]), add4(a[2], a[3]));",
        "red[warp][lane] = add4(add4(a[0], a[1]), a[2]);", ("bf16", "perpoint")),
    "colsum_skip_last_partial": (
        "the column sum's last block leaves the last row range's partial out", _TRUNK_CUH,
        "for (int t = warp; t < S; t += CS_WARPS)",
        "for (int t = warp; t < S - 1; t += CS_WARPS)", ("bf16", "perpoint")),
    "bwdrev_tail_row": (
        "K3's reverse-chain transpose leaves the ragged last tile's last du_b row unstored",
        _CU,
        "bulk_store_rows(du_b + m0 * lddu, (size_t)lddu * sizeof(T), tb, du_row, rows);",
        "bulk_store_rows(du_b + m0 * lddu, (size_t)lddu * sizeof(T), tb, du_row, rows - (rows < P));",
        ("bf16", "perpoint")),
    "bwdrev_no_pad": (
        "K3's reverse-chain transpose never writes du's zero padding (the tiles' padding "
        "columns keep what shared memory held)", _CU,
        "for (int i = tid; i < 4 * P * pad; i += BWR_THREADS)",
        "for (int i = tid; i < 0; i += BWR_THREADS)", ("bf16", "perpoint")),
    "bwdrev_dus_unscaled": (
        "K3's reverse-chain transpose stores du_s without the skip's 1/sqrt2", _CU,
        "row_s[col] = from_f32<T>(v * kInvSqrt2);",
        "row_s[col] = from_f32<T>(v);", ("bf16", "perpoint")),
    "uchain_last_vec": (
        "the u-chain's seed (uchain_seed_kernel, which only the split f32 launches call) leaves "
        "the last 8 columns of every row unwritten", _TRUNK_CUH,
        "  if (r >= rows) return;\n  float c[US_VEC];",
        "  if (r >= rows || j0 + US_VEC == width) return;\n  float c[US_VEC];",
        ("perpoint",)),
    "k4_skip_unscaled": (
        "K4's es tile keeps e without the skip's 1/sqrt2", _SDF_CU,
        "__float2bfloat16_rn(v * p.skip_scale);", "__float2bfloat16_rn(v);", ("perpoint",)),
    "k4_pe_tail": (
        "K4's prologue leaves the tile's last row's PE unwritten (what shared memory held)",
        _SDF_CU, "    const uint32_t off = k4_offset(64 * c + r, col);",
        "    if (64 * c + r == K4_TILE - 1) return;\n"
        "    const uint32_t off = k4_offset(64 * c + r, col);", ("perpoint",)),
    "copy_tail_col": (
        "the padded-row copy leaves each row's last column unwritten where it falls past the "
        "body's vectors", _TRUNK_CUH,
        "if (lane < width - t0) d[t0 + lane] = to_f32(s[t0 + lane]);",
        "if (lane < width - t0 - 1) d[t0 + lane] = to_f32(s[t0 + lane]);", ("perpoint",)),
    "copy_head_misaligned": (
        "the padded-row copy skips the scalar head of a row whose destination is off a 16-byte "
        "boundary", _TRUNK_CUH,
        "if (lane < h) d[lane] = to_f32(s[lane]);", "if (lane < 0) d[lane] = to_f32(s[lane]);",
        ("perpoint",)),
    "pack_straddle_no_zeros": (
        "the pack of e loads the columns past E of the vector that straddles E instead of "
        "zeroing them (K5 / K6's operand)", _FT_CU,
        "x[u][j] = c < E ? s[c] : 0.f;", "x[u][j] = c < E || v == nfull ? s[c] : 0.f;",
        ("perpoint",)),
    "pack_last_row": (
        "the pack of e leaves the last row of a call unwritten", _FT_CU,
        "m < M; m += gridDim.x * PK_WARPS) {", "m < M - 1; m += gridDim.x * PK_WARPS) {",
        ("perpoint",)),
    "pose_skip_last_partial": (
        "the pose sums' last block leaves the last block's partial out (K3's drotT / doff)",
        _CU, "red[r][c] = pose_thread_sum<true>(ws, 0, S, r, c);",
        "red[r][c] = pose_thread_sum<true>(ws, 0, S - 1, r, c);", ("perpoint",)),
    "trunk_skip_no_e": (
        "the fused forward's skip layer misses its e range (the 22 K steps over e's boxes)",
        _TF_CU, "(l == 0 || l == skip) ? Ep / 64 : 0,", "l == 0 ? Ep / 64 : 0,", ("trunk",)),
    "trunk_ragged_tail": (
        "the fused forward stores no sdf row of K1's last ragged tile", _TF_CU,
        "if (grow < p.M) p.sdf[grow] = acc[2 * h] + b0;",
        "if (grow < (p.M & ~(TF_TILE - 1))) p.sdf[grow] = acc[2 * h] + b0;", ("trunk",)),
    "uchain_u_no_skip": (
        "the fused u-chain's u misses the skip layer's part (its even columns)", _TF_CU,
        "const float u0 = __fadd_rn(__fmul_rn(acc[4 * j + 2 * h], p.escale), acc2[4 * j + 2 * h]);",
        "const float u0 = acc2[4 * j + 2 * h];", ("trunk",)),
    "trunk_ss_row_missing": (
        "the fused forward never stores layer 2's sigmoid row", _TF_CU,
        "      if (kSS && grow < p.M)\n",
        "      if (kSS && grow < p.M && ph.layer != 2)\n", ("trunk",)),
    "uchain_seed_column": (
        "the fused u-chain seeds from W_last's column 1, not the sdf column", _TF_CU,
        "w[i] = __bfloat162float(p.w_last[(size_t)(col + i) * p.ldw]);",
        "w[i] = __bfloat162float(p.w_last[(size_t)(col + i) * p.ldw + 1]);", ("trunk",)),
    "t32_small_dropped": (
        "the f32 trunk's pair drops the small terms of 3xTF32: big.big alone (1xTF32)",
        _TF32_CUH,
        "      t32_mma<NW>(fresh, ab[kk], wg::smem_desc(b1 + 32 * kk, wg::K_MAJOR_LBO, wg::SBO),\n"
        "                  kk ? 1 : open);\n"
        "    wg::wgmma_commit();\n"
        "    const int s2 = (it + 1) % stages;\n"
        "    wg::mbar_wait(full + 8 * s2, ((it + 1) / stages) & 1);\n"
        "    const uint32_t b2 = ring + s2 * stage_bytes + boff;\n"
        "#pragma unroll\n"
        "    for (int kk = 0; kk < 4; ++kk)\n"
        "      t32_mma<NW>(fresh, as[kk], wg::smem_desc(b2 + 32 * kk, wg::K_MAJOR_LBO, wg::SBO), 1);\n"
        "#pragma unroll\n"
        "    for (int kk = 0; kk < 4; ++kk)\n"
        "      t32_mma<NW>(fresh, ab[kk], wg::smem_desc(b2 + 32 * kk, wg::K_MAJOR_LBO, wg::SBO), 1);\n",
        "      (void)b1;\n"
        "    wg::wgmma_commit();\n"
        "    const int s2 = (it + 1) % stages;\n"
        "    wg::mbar_wait(full + 8 * s2, ((it + 1) / stages) & 1);\n"
        "    const uint32_t b2 = ring + s2 * stage_bytes + boff;\n"
        "#pragma unroll\n"
        "    for (int kk = 0; kk < 4; ++kk)\n"
        "      t32_mma<NW>(fresh, ab[kk], wg::smem_desc(b2 + 32 * kk, wg::K_MAJOR_LBO, wg::SBO),\n"
        "                  kk ? 1 : open);\n", ("trunk",)),
    "t32_one_accumulator": (
        "the f32 trunk's four fused kernels (the forward pair and the backward pair: their "
        "shared K step, tf32.cuh) sum every K step into one accumulator (no fresh sum a step)",
        _TF32_CUH,
        "  for (int i = 0; i < R; ++i) run[i] = __fadd_rn(run[i], fresh[i]);\n  return 0;",
        "  for (int i = 0; i < R; ++i) run[i] = fresh[i];\n  return 1;", ("trunk", "trunkbwd32")),
    "t32_ragged_tail": (
        "the f32 forward stores no z row of the ragged last tile", _T32_CU,
        "      if (grow >= p.M) continue;\n      float* zr",
        "      if (grow >= (p.M & ~(TF32_TILE - 1))) continue;\n      float* zr", ("trunk",)),
    "t32_seed_column": (
        "the f32 u-chain seeds from W_last's column 1, not the sdf column", _T32_CU,
        "w[i] = p.w_last[(size_t)(col + i) * p.ldw];",
        "w[i] = p.w_last[(size_t)(col + i) * p.ldw + 1];", ("trunk",)),
    "t32_skip_bf16_scale": (
        "the f32 forward scales the skip concat by bf16(1/sqrt2), not f32(1/sqrt2)", _TRUNK_PY,
        "_ints([w.shape[1] for w in ws]), _ptrs(bs), INV_SQRT2, ss.data_ptr(),",
        "_ints([w.shape[1] for w in ws]), _ptrs(bs), INV_SQRT2_BF16, ss.data_ptr(),",
        ("trunk",)),
    "tb32_ds_no_c": (
        "the f32 upward chain's ds misses its c term (ds = dt, not dt c)", _TB32_CU,
        "const float2 dv = make_float2(z0 * cv[j][h].x, z1 * cv[j][h].y);",
        "const float2 dv = make_float2(z0, z1);", ("trunkbwd32",)),
    "tb32_skip_du_s_dropped": (
        "the f32 upward chain's skip product skips du_s's boxes (the embedding's part of dm)",
        _TB32_CU, "l == skip ? Ep / TF32_BK : 0, l, 0, Hp, TB32_UT};",
        "0, l, 0, Hp, TB32_UT};", ("trunkbwd32",)),
    "tb32_dz_no_ds": (
        "the f32 downward chain's dz misses its second-order term ds beta s (1 - s)", _TB32_CU,
        "          (acc[4 * j + 2 * h] * hscale) * s.x + d.x * ((kBeta * s.x) * (1.f - s.x)),\n"
        "          (acc[4 * j + 2 * h + 1] * hscale) * s.y + d.y * ((kBeta * s.y) * (1.f - s.y)));",
        "          (acc[4 * j + 2 * h] * hscale) * s.x + 0.f * d.x,\n"
        "          (acc[4 * j + 2 * h + 1] * hscale) * s.y + 0.f * d.y);", ("trunkbwd32",)),
    "tb32_skip_de_dropped": (
        "the f32 downward chain drops the skip's part of de (layer 0's alone)", _TB32_CU,
        "*de = make_float2(__fmul_rn(a0, p.escale), __fmul_rn(a1, p.escale));",
        "*de = make_float2(0.f, 0.f);", ("trunkbwd32",)),
    "tb32_ragged_tail": (
        "the f32 upward chain stores no ds (nor dm) row of the ragged last tile", _TB32_CU,
        "      if (grow < p.M) {\n        *reinterpret_cast<float2*>(ds",
        "      if (grow < (p.M & ~(TF32_TILE - 1))) {\n        *reinterpret_cast<float2*>(ds",
        ("trunkbwd32",)),
    "tdw32_drop_partial": (
        "the f32 weight gradients' tile sum leaves out the last split's partial", _TDW32_CU,
        "for (int sp = 1; sp < w.splits; ++sp) {", "for (int sp = 1; sp < w.splits - 1; ++sp) {",
        ("trunkdw32",)),
    "tdw32_small_b_dropped": (
        "the f32 weight gradients' transposed split stores B's small rows as zeros (the "
        "big.small product of 3xTF32 adds nothing)", _TDW32_CU,
        "*reinterpret_cast<uint4*>(buf + off) = make_uint4(small[0], small[1], small[2], small[3]);",
        "*reinterpret_cast<uint4*>(buf + off) = make_uint4(0u, 0u, 0u, 0u);", ("trunkdw32",)),
    "tdw32_skip_e_unscaled": (
        "the f32 weight gradients' work list loses the skip's 1/sqrt2 on its embedding rows (the "
        "forward product's [a | e] / sqrt2, e's part)", _TRUNK_PY,
        "f = T(MMA, (S(0, Hp, ACT, l - 1, 0, 1), S(Hp, Ep, E, 0, 0, 1)), (DZ, l))",
        "f = T(MMA, (S(0, Hp, ACT, l - 1, 0, 1), S(Hp, Ep, E, 0, 0, 0)), (DZ, l))",
        ("trunkdw32",)),
    "tdw32_db_last_row": (
        "the f32 weight gradients' db leaves out the last row of every 32-point K step (the "
        "ragged last step's last row among them)", _TDW32_CU,
        "__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], v[3])));",
        "__fadd_rn(__fadd_rn(v[0], v[1]), __fadd_rn(v[2], q == 7 ? 0.f : v[3])));",
        ("trunkdw32",)),
    "tdw32_no_colsum": (
        "the f32 weight gradients' launch does not add dm_{n-1}'s column sum into the last "
        "layer's dW column 0 (its u-chain part)", _TDW32_CU,
        "      run[0] = __fadd_rn(run[0], rs0);\n      run[2] = __fadd_rn(run[2], rs1);\n",
        "", ("trunkdw32",)),
    "cf32_no_mask": (
        "the f32 color transpose skips the relu masks (da for dz at every unit)", _CF32_CU,
        "      const float2 v = make_float2(av[j][h].x > 0.f ? acc[4 * j + 2 * h] : 0.f,\n"
        "                                   av[j][h].y > 0.f ? acc[4 * j + 2 * h + 1] : 0.f);",
        "      const float2 v = make_float2(acc[4 * j + 2 * h] + 0.f * av[j][h].x,\n"
        "                                   acc[4 * j + 2 * h + 1] + 0.f * av[j][h].y);",
        ("color32",)),
    "cf32_cx2_dropped": (
        "the f32 color forward's layer 0 leaves out cx2's K range ([feat | grad-PE])", _CF32_CU,
        "l == 0 ? X / TF32_BK : 0, l, 0, cols[l],", "0, l, 0, cols[l],", ("color32",)),
    "cf32_one_tf32": (
        "the f32 fused kernels' shared K step (tf32.cuh) keeps one TF32 product, big.big (the "
        "small terms dropped)", _TF32_CUH,
        "      t32_mma<NW>(fresh, ab[kk], wg::smem_desc(b1 + 32 * kk, wg::K_MAJOR_LBO, wg::SBO),\n"
        "                  kk ? 1 : open);\n"
        "    wg::wgmma_commit();\n"
        "    const int s2 = (it + 1) % stages;\n"
        "    wg::mbar_wait(full + 8 * s2, ((it + 1) / stages) & 1);\n"
        "    const uint32_t b2 = ring + s2 * stage_bytes + boff;\n"
        "#pragma unroll\n"
        "    for (int kk = 0; kk < 4; ++kk)\n"
        "      t32_mma<NW>(fresh, as[kk], wg::smem_desc(b2 + 32 * kk, wg::K_MAJOR_LBO, wg::SBO), 1);\n"
        "#pragma unroll\n"
        "    for (int kk = 0; kk < 4; ++kk)\n"
        "      t32_mma<NW>(fresh, ab[kk], wg::smem_desc(b2 + 32 * kk, wg::K_MAJOR_LBO, wg::SBO), 1);\n",
        "      (void)b1;\n"
        "    wg::wgmma_commit();\n"
        "    const int s2 = (it + 1) % stages;\n"
        "    wg::mbar_wait(full + 8 * s2, ((it + 1) / stages) & 1);\n"
        "    const uint32_t b2 = ring + s2 * stage_bytes + boff;\n"
        "#pragma unroll\n"
        "    for (int kk = 0; kk < 4; ++kk)\n"
        "      t32_mma<NW>(fresh, ab[kk], wg::smem_desc(b2 + 32 * kk, wg::K_MAJOR_LBO, wg::SBO),\n"
        "                  kk ? 1 : open);\n", ("color32",)),
    "cf32_ragged_tail": (
        "the f32 color transpose stores no dx row of the ragged last tile", _CF32_CU,
        "      if (grow < p.M)\n        *reinterpret_cast<float2*>(p.dx",
        "      if (grow < (p.M & ~(TF32_TILE - 1)))\n        *reinterpret_cast<float2*>(p.dx",
        ("color32",)),
    "cf32_dz_no_sprime": (
        "the f32 color transpose seeds dz = dcolor, without the sigmoid's s (1 - s)", _CF32_CU,
        "v = s * (1.f - s) * p.dcolor[(size_t)grow * p.lddc + col];",
        "v = 0.f * s + p.dcolor[(size_t)grow * p.lddc + col];", ("color32",)),
    "cf32_no_cdz": (
        "the f32 color transpose writes no dz row of layers below the top (the dW launch reads "
        "whatever the rows held)", _CF32_CU,
        "      if (dz && grow < p.M) *reinterpret_cast<float2*>(dz + (size_t)grow * p.lddz + col) = v;\n",
        "", ("color32",)),
    "cf16_no_mask": (
        "the bf16 color transpose skips the relu masks (da for dz at every unit)", _CF16_CU,
        "        const float v0 = __bfloat162float(m2.x) > 0.f ? acc[4 * j + 2 * h] : 0.f;\n"
        "        const float v1 = __bfloat162float(m2.y) > 0.f ? acc[4 * j + 2 * h + 1] : 0.f;\n",
        "        const float v0 = acc[4 * j + 2 * h] + 0.f * __bfloat162float(m2.x);\n"
        "        const float v1 = acc[4 * j + 2 * h + 1] + 0.f * __bfloat162float(m2.y);\n",
        ("color16",)),
    "cf16_cx2_dropped": (
        "the bf16 color forward's layer 0 leaves out cx2's K range ([feat | grad-PE])", _CF16_CU,
        "l == 0 ? X / 64 : 0, l, 0,", "0, l, 0,", ("color16",)),
    "cf16_ragged_tail": (
        "the bf16 color transpose stores no dx row of the ragged last tile", _CF16_CU,
        "      if (grow < p.M)\n        *reinterpret_cast<float2*>(p.dx",
        "      if (grow < (p.M & ~(CF16_TILE - 1)))\n        *reinterpret_cast<float2*>(p.dx",
        ("color16",)),
    "cf16_dz_no_sprime": (
        "the bf16 color transpose seeds dz = dcolor, without the sigmoid's s (1 - s)", _CF16_CU,
        "v[k] = s * (1.f - s) * p.dcolor[(size_t)grow * p.lddc + c8 + k];",
        "v[k] = 0.f * s + p.dcolor[(size_t)grow * p.lddc + c8 + k];", ("color16",)),
    "cf16_no_dz_rows": (
        "the bf16 color transpose writes no bf16 dz row of the layers below the top (the dW "
        "GEMMs read whatever the rows held)", _CF16_CU,
        "          if (dz) cf16_store_rows(&p.dzb_map[ph.layer - 1], act, p.H, c, tile);\n",
        "", ("color16",)),
    "cf16_skip_last_k": (
        "the bf16 color pair's 256-wide products skip the last K step of every phase", _CF16_CU,
        "      if constexpr (R == 128)\n"
        "        wg::wgmma_m64n256k16<0, 1>(acc, da, db, 1);\n"
        "      else if constexpr (R == 64)",
        "      if constexpr (R == 128) {\n"
        "        if (k + 1 < steps) wg::wgmma_m64n256k16<0, 1>(acc, da, db, 1);\n"
        "      } else if constexpr (R == 64)", ("color16",)),
    "tb16_ds_no_c": (
        "the bf16 upward chain's ds misses its c term (ds = dt, not dt c)", _TB16_CU,
        "const float2 d = make_float2(z0 * cv[jj][h].x, z1 * cv[jj][h].y);",
        "const float2 d = make_float2(z0 + 0.f * cv[jj][h].x, z1 + 0.f * cv[jj][h].y);",
        ("tbwd16",)),
    "tb16_dz_no_ds": (
        "the bf16 downward chain's dz misses its second-order term ds beta s (1 - s)", _TB16_CU,
        "__fmul_rn(ds, __fmul_rn(__fmul_rn(kBeta, s), __fsub_rn(1.f, s))));",
        "0.f * ds);", ("tbwd16",)),
    "tb16_skip_de_dropped": (
        "the bf16 downward chain drops the skip's part of de (layer 0's alone)", _TB16_CU,
        "            __fadd_rn(__fmul_rn(acc[4 * j + 2 * h], p.escale), acc2[4 * j + 2 * h]),\n"
        "            __fadd_rn(__fmul_rn(acc[4 * j + 2 * h + 1], p.escale), acc2[4 * j + 2 * h + 1]));",
        "            __fadd_rn(0.f * acc[4 * j + 2 * h], acc2[4 * j + 2 * h]),\n"
        "            __fadd_rn(0.f * acc[4 * j + 2 * h + 1], acc2[4 * j + 2 * h + 1]));",
        ("tbwd16",)),
    "tb16_skip_du_s_dropped": (
        "the bf16 upward chain's skip product skips du_s's boxes (the embedding's part of dm)",
        _TB16_CU, "l == skip ? Ep / 64 : 0, l,", "0, l,", ("tbwd16",)),
    "tb16_ragged_tail": (
        "the bf16 upward chain stores no ds row of the ragged last tile", _TB16_CU,
        "if (grow < p.M) *reinterpret_cast<float2*>(ds + (size_t)grow * p.ldds + col) = d;",
        "if (grow < (p.M & ~(TB16_TILE - 1)))\n"
        "          *reinterpret_cast<float2*>(ds + (size_t)grow * p.ldds + col) = d;",
        ("tbwd16",)),
    "tb16_no_dm_rows": (
        "the bf16 upward chain keeps no dm row (the dW launches read whatever the rows held: "
        "the chains' own outputs stay right)", _TB16_CU,
        "  if (p.keep) tb16_store_rows(&p.dm_map, act, p.Hp, c, tile, l);\n", "",
        ("tbwd16",)),
    "pose_drop_tail": (
        "the pose sums drop the rows past the last full split (a ragged last block sums "
        "nothing)", _CU, "const int r0 = s * split, r1 = min(M, r0 + split);",
        "const int r0 = s * split, r1 = r0 + split <= M ? r0 + split : r0;", ("perpoint",)),
    "video_frame0_bt": (
        "the video step renders every frame of the window with frame 0's bone transforms (the "
        "reference's batched renderer's fault)", _VIDEO_PY,
        "hand_field = make_hand_field(hand, hand_sdf_cfg, hand_color_cfg, bt_inv[f], t_pose,",
        "hand_field = make_hand_field(hand, hand_sdf_cfg, hand_color_cfg, bt_inv[0], t_pose,",
        ("video",)),
    "video_window_rows_only": (
        "the video step's Adam moves the window's rows alone (the other rows keep their "
        "values: an earlier window's rows stop moving on their moments)", _VIDEO_PY,
        "        state[\"opt\"].step()\n",
        "        rows = torch.ones(n_frames, dtype=torch.bool, device=batch[\"index\"].device)\n"
        "        rows[batch[\"index\"]] = False\n"
        "        before = {k: tables[k].detach().clone() for k in POSE_KEYS}\n"
        "        state[\"opt\"].step()\n"
        "        with torch.no_grad():\n"
        "            for k in POSE_KEYS:\n"
        "                tables[k][rows] = before[k][rows]\n", ("video",)),
}
GROUPS = ("bf16", "f32", "fit", "perpoint", "trunk", "trunkbwd32", "trunkdw32", "color32",
          "color16", "tbwd16", "video")
KERNEL_SEEDS = {"sound": (0, 1, 2, 3, 4, 5)}
KUNIT_SEEDS = {"sound": (0, 1, 2, 3)}
STEP_SEEDS = {"sound": (1, 2, 3, 4)}
K6_SEEDS = {"sound": (0, 1, 2)}
K6UNIT_SEEDS = {"sound": (0, 1)}
K6STEP_SEEDS = {"sound": (1, 2)}
F32_SEEDS = {"sound": (0, 1)}
FITK1_SEEDS = {"sound": (2, 3, 4)}


def prepare(name: str) -> str:
    """A copy of honerf_torch with the fault's edit; returns its root."""
    root = os.path.join(WORK, name)
    shutil.rmtree(os.path.join(root, "honerf_torch"), ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "honerf_torch"), os.path.join(root, "honerf_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    if name != "sound":
        _, rel, text, repl, _ = FAULTS[name]
        path = os.path.join(root, rel)
        with open(path) as f:
            src = f.read()
        if src.count(text) != 1:
            raise ValueError(f"{name}: the text to edit occurs {src.count(text)} times in {rel}")
        with open(path, "w") as f:
            f.write(src.replace(text, repl))
    return root


def fwd_rows(CS, torch, names, got, want):
    """[what, max |err| / range, within TOL_F32 at the median and max] of
    an f32 forward against its plain version."""
    rows = []
    for w, a, b in zip(names, got, want):
        ok = CS.compare(torch, w, a, b, CS.TOL_F32, CS.TOL_F32)[0]
        _, _, mx, scale = CS.err_readings(torch, a, b)
        rows.append([w, mx / scale, ok])
    return rows


def child(name: str, root: str, groups) -> None:
    """Run the checks of the fault's groups among `groups` (every group's
    for the sound kernels) on the package under root; print the readings
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
    groups = [g for g in (GROUPS if name == "sound" else FAULTS[name][4]) if g in groups]
    out = {"fault": name}
    if "bf16" in groups:
        out.update({k: {} for k in ("kernel", "kunit", "unit", "step", "k6", "k6unit",
                                    "k6step")})
        fs = CS.flagship(torch, dev)
        for seed in KERNEL_SEEDS.get(name, (0,)):
            args = CS.step_bwd_inputs(torch, fs, dev, seed)
            _, rows = CS.k3_check(torch, args)
            out["kernel"][str(seed)] = [[r.what, r.l2, r.med, r.mx, r.ok] for r in rows]
            if seed in KUNIT_SEEDS.get(name, (0,)):
                out["kunit"][str(seed)] = [[r.what, r.ratio, r.err, r.floor, r.norm]
                                           for r in CS.k3_unit_check(torch, args)]
        for case, (sdf_kw, n) in TC.BWD_CASES.items():
            try:
                out["unit"][case] = TC.bwd_rule_readings(sdf_kw, n, dev)[1]
            except AssertionError as exc:   # a non-finite output fails the card test itself
                out["unit"][case] = [[f"assertion {exc}", float("inf")]]
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
        out["bgemm"] = {"0": [[r.what, r.l2, r.ok]
                              for r in CS.bf16_gemm_readings(torch, dev, timed=False)]}
    if set(groups) & {"f32", "trunkbwd32", "trunkdw32", "color32"}:
        # K3 f32 with dW and K5 / K6 f32 on an f32 step's inputs: the f32
        # group's, and the f32 trunk backward's, weight gradients' and color
        # net's (trunkbwd32, trunkdw32, color32)
        from honerf_torch.ops import fused_fine as FT

        fs = CS.flagship(torch, dev, "f32")
        out["f32k3"] = {}
        for seed in F32_SEEDS.get(name, (0,)):
            args = CS.step_bwd_inputs(torch, fs, dev, seed)
            out["f32k3"][str(seed)] = [[r.what, r.l2, r.ok]
                                       for r in CS.f32_bwd_check(torch, args)[1]]
        args = CS.step_bwd_inputs(torch, fs, dev, mode="pallas")
        out["f32k6"] = {"0": (fwd_rows(CS, torch, ("out", "u"),
                                       FT.hand_trunk_sdf_u_fwd(*args[:2]),
                                       FT.hand_trunk_sdf_u_plain(*args[:2]))
                              + [[r.what, r.l2, r.ok]
                                 for r in CS.f32_bwd_check(torch, args, "pallas")[1]])}
    if "f32" in groups:
        from honerf_torch.ops import fused_fine_full as FF

        out.update({k: {} for k in ("f32nc", "f32step")})
        out["gemm"] = {"0": [[r.what, r.l2, r.ok]
                             for r in CS.f32_gemm_readings(torch, dev, timed=False)]}
        args = CS.step_bwd_inputs(torch, fs, dev, mode="full_nocolor")
        out["f32nc"]["0"] = (fwd_rows(CS, torch, ("out", "g", "e"),
                                      FF.hand_fine_color_fwd(*args[:5]),
                                      FF.hand_fine_color_plain(*args[:5]))
                             + [[r.what, r.l2, r.ok]
                                for r in CS.f32_bwd_check(torch, args, "full_nocolor")[1]])
        for mode in ("full", "full_nocolor", "pallas"):
            r = CS.train_check_readings(torch, fs, dev, 1, mode=mode)
            out["f32step"][mode] = {"loss": r.worst_metric, "leaves": r.rel}
        out["f32unit"] = {f"{kind} {case}": TC.f32_bwd_rule_readings(kind, sdf_kw, n, dev)[2]
                          for kind in ("color", "nocolor", "trunk")
                          for case, (sdf_kw, n) in TC.F32_BWD_CASES.items()}
    if set(groups) & {"fit", "trunkbwd32", "color32"}:
        # the frozen K3 f32 and K5 / K6 f32 at a fit step: the fit group's,
        # and the f32 trunk backward's and color net's (trunkbwd32, color32)
        from honerf_torch.ops import fused_fine as FT

        fn = CS.fit_nets(torch, dev)
        out.update({k: {} for k in ("fitk3", "fitk6")})
        args = CS.fit_step_inputs(torch, fn, dev)
        for label, seed in (("own", None), ("unit", 3)):
            out["fitk3"][label] = [[r.what, r.l2, r.ok] for r in CS.f32_bwd_check(
                torch, args, want_dw=False, seed=seed, shared_g=False)[1]]
        args = CS.fit_step_inputs(torch, fn, dev, "12", mode="pallas")
        out["fitk6"]["fwd"] = fwd_rows(CS, torch, ("out", "u"), FT.hand_trunk_sdf_u_fwd(*args[:2]),
                                       FT.hand_trunk_sdf_u_plain(*args[:2]))
        for label, seed in (("own", None), ("unit", 3)):
            out["fitk6"][label] = [[r.what, r.l2, r.ok] for r in CS.f32_bwd_check(
                torch, args, "pallas", want_dw=False, seed=seed)[1]]
    if "fit" in groups:
        out.update({k: {} for k in ("fitf64", "fitgrid", "fitk1", "fitnc")})

        r = CS.fit_check_readings(torch, fn, dev, fused_ladder=False, seed=2, terms=True)
        out["fitf64"]["2"] = {"ratio": max(CS.fit_f64_ratios(r)),
                              "render": CS.fit_render_ratios(r)}
        for mode in ("full", "full_nocolor", "pallas"):
            r = CS.fit_check_readings(torch, fn, dev, fused_ladder=False, seed=2, mode=mode,
                                      batch_fn=CS.fit_grid_batch, terms=True)
            out["fitgrid"][mode] = {"loss": max(r.card_cpu[0].values()),
                                    "grad": max(r.card_cpu[1]), "render": r.render_card_cpu}
        for seed in FITK1_SEEDS.get(name, (2,)):
            r = CS.fit_check_readings(torch, fn, dev, fused_ladder=True, seed=seed,
                                      batch_fn=CS.fit_grid_batch)
            med, _, mx, scale = r.k1
            out["fitk1"][str(seed)] = {"ratio": max(CS.fit_f64_ratios(r)),
                                       "k1_median": med / scale, "k1_max": mx / scale}
        from honerf_torch.ops import fused_fine_full as FF

        for check, mode, fwd, plain, names, lead in (
                ("fitnc", "full_nocolor", FF.hand_fine_color_fwd, FF.hand_fine_color_plain,
                 ("out", "g", "e"), 5),):
            args = CS.fit_step_inputs(torch, fn, dev, "12", mode=mode)
            out[check]["fwd"] = fwd_rows(CS, torch, names, fwd(*args[:lead]), plain(*args[:lead]))
            for label, seed in (("own", None), ("unit", 3)):
                out[check][label] = [[r.what, r.l2, r.ok] for r in CS.f32_bwd_check(
                    torch, args, mode, want_dw=False, seed=seed)[1]]
    if "video" in groups:
        r = CS.video_check_readings(torch, CS.fit_nets(torch, dev), dev)
        out["video"] = {"worst": CS.video_check_worst(r), "frames": r.frames, "adam": r.adam,
                        "steps": [{"f64": max(x.f64.values()), "whole": x.whole,
                                   "updates": max(x.updates.values())} for x in r.steps]}
    if "perpoint" in groups:
        pose, pts = CS.perpoint_pose(torch, dev)
        emb, cols = CS.perpoint_readings(torch, dev, pose, pts, *CS.perpoint_calls(torch),
                                         timed=False)
        seeds = CS.seed_readings(torch, dev, CS.seed_calls(torch), timed=False)
        revs = CS.bwdrev_readings(torch, dev, pose, pts, CS.bwdrev_calls(torch), timed=False)
        out["ppt"] = {"0": [[f"embed {r.m} {r.dtype}", r.max_abs, r.ok] for r in emb]
                      + [[f"colsum N {r.N} m {r.m}", r.f64 if r.same else float("inf"), r.ok]
                         for r in cols]
                      + [[f"seed {r.m} {r.dtype}", r.max_abs if r.ok else float("inf"), r.ok]
                         for r in seeds]
                      + [[f"bwdrev {r.m} {r.dtype}", r.max_abs if r.ok else float("inf"), r.ok]
                         for r in revs]}
        out["k4"] = {"0": k4_rows(CS, torch, dev)}
        out["copy"] = {label: [[f"copy {r.width} {r.dtype} +{r.so}",
                                r.max_abs if r.ok else float("inf"), r.ok]
                               for r in CS.copy_readings(torch, dev, calls, timed=False)]
                       for label, calls in CS.copy_calls(torch).items()}
        rg_pack, rg_pose = CS.ragged_pack_pose_calls(torch)
        out["pack"] = {label: [[f"pack {r.m} {r.dtype} +{r.so}",
                                r.max_abs if r.ok else float("inf"), r.ok]
                               for r in CS.pack_readings(torch, dev, calls, timed=False)]
                       for label, calls in dict(CS.pack_calls(torch), ragged=rg_pack).items()}
        out["pose"] = {label: [[f"pose {r.m} acc {r.acc}", r.f64 if r.ok else float("inf"),
                                r.ok]
                               for r in CS.pose_readings(torch, dev, calls, timed=False)]
                       for label, calls in dict(CS.pose_calls(torch), ragged=rg_pose).items()}
    if "trunk" in groups:
        out["trunk"] = {"0": trunk_rows(CS, torch, dev)}
        nets = CS.trunk32_nets(torch, dev)
        out["trunk32"] = {"0": [
            [f"f32 pair {r.m} last {r.a} keep {r.keep} u {r.with_u}",
             max(r.rule, r.l2_ratio) if r.same else float("inf"), r.ok]
            for r in CS.trunk32_readings(torch, dev, nets, CS.ragged_trunk32_pairs(),
                                         timed=False)]}
    if "trunkbwd32" in groups:
        nets = CS.trunk32_nets(torch, dev)
        out["tbwd32"] = {"0": [
            [f"f32 backward pair {r.m} keep {r.keep}",
             max(r.rule, r.l2_ratio) if r.same else float("inf"), r.ok]
            for r in CS.trunk_bwd32_readings(torch, dev, nets, CS.ragged_trunk_bwd32_calls(),
                                             timed=False)]}
    if "trunkdw32" in groups:
        nets = CS.trunk32_nets(torch, dev)
        calls = CS.ragged_trunk_dw32_calls() + [(28288, True), (28288, False)]
        out["tdw32"] = {"0": [
            [f"f32 dW {r.m} color {r.color}",
             max(r.rule, r.l2_ratio) if r.same else float("inf"), r.ok]
            for r in CS.trunk_dw32_readings(torch, dev, nets, calls, timed=False)]}
    if "color32" in groups:
        nets = CS.trunk32_nets(torch, dev)
        calls = CS.ragged_color32_calls() + [(k, 28224, f) for k in ("cfwd", "cbwd")
                                             for f in (False, True)]
        out["color32"] = {"0": [
            [f"f32 color {r.kind} {r.m} {r.flag}",
             max(r.rule, r.l2_ratio) if r.same else float("inf"), r.ok]
            for r in CS.color32_readings(torch, dev, nets, calls, timed=False)]}
    if "color16" in groups:
        nets = CS.trunk_nets(torch, dev)
        calls = CS.ragged_color16_calls() + [(k, 56448, f) for k in ("cfwd16", "cbwd16")
                                             for f in (False, True)]
        out["color16"] = {"0": [
            [f"bf16 color {r.kind} {r.m} {r.flag}", r.rule if r.same else float("inf"), r.ok]
            for r in CS.color16_readings(torch, dev, nets, calls, timed=False)]}
        if "kernel" not in out:   # K3 on a bf16 step, whose color net the pair runs
            args = CS.step_bwd_inputs(torch, CS.flagship(torch, dev), dev, 0)
            _, rows = CS.k3_check(torch, args)
            out["kernel"] = {"0": [[r.what, r.l2, r.med, r.mx, r.ok] for r in rows]}
    if "tbwd16" in groups:
        nets = CS.trunk_nets(torch, dev)
        calls = CS.ragged_trunk_bwd32_calls() + [(56448, True), (56448, False)]
        out["tbwd16"] = {"0": [
            [f"bf16 backward pair {r.m} keep {r.keep}",
             r.rule if r.same and not r.moved else float("inf"), r.ok]
            for r in CS.trunk_bwd16_readings(torch, dev, nets, calls, timed=False)]}
        fs = CS.flagship(torch, dev)
        if "kernel" not in out:   # K3 and K6 on a bf16 step, whose trunk backward the pair runs
            _, rows = CS.k3_check(torch, CS.step_bwd_inputs(torch, fs, dev, 0))
            out["kernel"] = {"0": [[r.what, r.l2, r.med, r.mx, r.ok] for r in rows]}
        if "k6" not in out:
            _, rows = CS.k3_check(torch, CS.step_bwd_inputs(torch, fs, dev, 0, mode="pallas"),
                                  "pallas")
            out["k6"] = {"0": [[r.what, r.l2, r.med, r.mx, r.ok] for r in rows]}
    print(json.dumps(out))


def trunk_rows(CS, torch, dev):
    """[what, max |err| / range, within the kernel rule and a rerun's bits]
    of the fused trunk (chip_smoke.trunk_readings at ragged_trunk_calls),
    K1 through fused_hand_sdf against fused_hand_sdf_plain at ragged sizes
    (the kernel rule), and the forward's reciprocal's mismatches against
    __frcp_rn on [1, 2] (none)."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_hand as FH

    nets = CS.trunk_nets(torch, dev)
    rows = [[f"{r.kind} {r.m} {r.a} keep {r.keep}", r.worst if r.ok else float("inf"), r.ok]
            for r in CS.trunk_readings(torch, dev, nets, CS.ragged_trunk_calls(), timed=False)]
    for n in (1, 63, 65, 1001, 65613):
        args = (nets.pts[:n], *nets.pose, nets.k1.ws, nets.k1.bs, nets.k1.meta)
        got, want = FH.fused_hand_sdf(*args), FH.fused_hand_sdf_plain(*args)
        ok = CS.compare(torch, "sdf", got, want)[0]
        _, _, mx, scale = CS.err_readings(torch, got, want)
        rows.append([f"k1 {n}", mx / scale if ok else float("inf"), ok])
    bad = FT.rcp12_mismatches(dev)
    rows.append(["rcp12 mismatches", float(bad), bad == 0])
    return rows


def k4_rows(CS, torch, dev):
    """[what, max |err| / range, within the kernel rule] of K4 against its
    plain version on the object conf's net, at the card test's sizes (a
    point, the consumer halves' edges, a ragged size, more tiles than SMs)."""
    import numpy as np

    from honerf_torch.ops import fused_sdf as FS

    obj = CS.obj_flagship(torch, dev)
    fused = FS.FusedObjSDF(obj.params["sdf"], obj.sdf)
    rng = np.random.default_rng(1)
    rows = []
    for n in (1, 63, 64, 65, 1001, 65536 + 77):
        pts = torch.as_tensor(rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32), device=dev)
        got, want = fused(pts), FS.fused_obj_sdf_plain(pts, fused.ws, fused.bs, fused.meta)
        ok = CS.compare(torch, "sdf", got, want)[0] and bool(torch.isfinite(got).all())
        _, _, mx, scale = CS.err_readings(torch, got, want)
        rows.append([f"k4 {n}", mx / scale, ok])
    return rows


def judge(CS, res):
    """{check: (caught, text)} of one child's readings (the checks it ran)."""
    verdict = {}
    for check in ("kernel", "k6"):
        if check not in res:
            continue
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
    for check in ("bgemm", "gemm", "f32k3", "f32nc", "f32k6", "fitk3", "fitnc", "fitk6", "ppt",
                  "k4", "copy", "pack", "pose", "trunk", "trunk32", "tbwd32", "tdw32",
                  "color32", "color16", "tbwd16"):
        if check not in res:
            continue
        worst, over = (-1.0, ""), []
        for seed, rows in res[check].items():
            for what, val, ok in rows:   # forwards: max |err| / range; the rest: L2
                val = float("inf") if val != val else val
                if val > worst[0]:
                    worst = (val, f"{what}@{seed}")
                if not ok:
                    over.append(f"{what}@{seed}")
        verdict[check] = (bool(over), f"worst {worst[0]:.2e} ({worst[1]})"
                          + (f"; over: {' '.join(over[:8])}" if over else ""))
    for check in ("kunit", "unit", "k6unit", "f32unit"):
        if check not in res:
            continue
        ratio, where = -1.0, ""
        for case, ratios in res[check].items():
            for what, r, *_ in ratios:
                r = float("inf") if r != r else r
                if r > ratio:
                    ratio, where = r, f"{case} {what}"
        verdict[check] = (ratio > 1.0, f"worst {ratio:.3g} ({where})")
    limits = {"step": (CS.TOL_TRAIN_LOSS, CS.TOL_TRAIN_GRAD),
              "k6step": (CS.TOL_TRAIN_LOSS, CS.TOL_TRAIN_GRAD),
              "f32step": (CS.TOL_TRAIN_F32_LOSS, CS.TOL_TRAIN_F32_GRAD)}
    for check, (tol_loss, tol_leaf) in limits.items():
        if check not in res:
            continue
        loss = max(s["loss"] for s in res[check].values())
        leaf = max(max(s["leaves"]) for s in res[check].values())
        loss, leaf = (float("inf") if x != x else x for x in (loss, leaf))
        verdict[check] = (loss > tol_loss or leaf > tol_leaf, f"loss {loss:.3g}, leaf {leaf:.3g}")
    def nan_inf(x):
        return float("inf") if x != x else x

    if "fitf64" in res:
        ratio = nan_inf(max(s["ratio"] for s in res["fitf64"].values()))
        render = nan_inf(max(max(s["render"].values()) for s in res["fitf64"].values()))
        verdict["fitf64"] = (ratio > 1.0 or render > 1.0, f"worst {ratio:.3g} of the limit, "
                             f"render terms {render:.3g}")
    if "fitgrid" in res:
        worst = nan_inf(max(max(s["loss"], s["grad"]) for s in res["fitgrid"].values()))
        render = nan_inf(max(max(s["render"].values()) for s in res["fitgrid"].values()))
        verdict["fitgrid"] = (worst > CS.TOL_FIT_HEAD_ON or render > CS.TOL_FIT_RENDER,
                              f"worst {worst:.3g}; render terms {render:.3g}")
    if "fitk1" in res:
        ratio, med, mx = (max(s[k] for s in res["fitk1"].values())
                          for k in ("ratio", "k1_median", "k1_max"))
        ratio, med, mx = (float("inf") if x != x else x for x in (ratio, med, mx))
        verdict["fitk1"] = (ratio > 1.0 or med > CS.TOL_MEDIAN or mx > CS.TOL_MAX,
                            f"worst {ratio:.3g} of the limit; K1 at the ladder points median "
                            f"{med:.2e}, max {mx:.2e} of the range")
    if "video" in res:
        v = res["video"]
        worst = float("inf") if v["worst"] != v["worst"] else v["worst"]
        verdict["video"] = (worst > 1.0, f"worst {worst:.3g} of its limit; frames "
                            + ", ".join(f"{k} {x:.2e}" for k, x in v["frames"].items())
                            + "; adam " + f"{max(v['adam'].values()):.2e}; card vs CPU "
                            + "; ".join(f"f64 rule {s['f64']:.3f} whole {s['whole']:.1e} "
                                        f"updates {s['updates']:.1e}" for s in v["steps"]))
    return verdict


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(WORK, "readings.json"))
    ap.add_argument("--only", help="comma-separated names (sound and FAULTS) to run")
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="comma-separated groups of checks to read (bf16, f32, fit, "
                         "perpoint, trunk, trunkbwd32, trunkdw32, color32, color16, "
                         "tbwd16, video)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    a = ap.parse_args()
    groups = a.groups.split(",")
    if a.child:
        child(a.child, a.root, groups)
        return 0
    sys.path.insert(0, ROOT)
    import chip_smoke as CS

    names = ["sound", *(n for n, f in FAULTS.items() if set(f[4]) & set(groups))]
    if a.only:
        names = [n for n in names if n in a.only.split(",")]
    results, bad = {}, []
    for name in names:
        t0 = time.time()
        root = prepare(name)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", name,
                               "--root", root, "--groups", a.groups], capture_output=True,
                              text=True, timeout=1500)
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
