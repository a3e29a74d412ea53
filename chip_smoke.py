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
  2b. bf16 GEMMs  gemm_kernel and gemm_tn_kernel (wgmma on a TMA ring,
              ops/csrc/wgmma.cuh) alone at a bf16 pass's 65,536 points and
              the trunk's shapes (bf16_gemm_readings: the five NN shapes
              of the f32 GEMMs' phase with the skip's bf16(1/sqrt2), the
              color net's input K 1664, four dW shapes, with and without
              x_scale), against the f64 sum of the same bf16 operands
              (TOL_GEMM_BF16_L2 in L2; max and mean shrink logged), the
              same bits on a rerun, ms beside the plain version (the f32
              product) and one bf16 torch.matmul;
  3. serve    the hand model's novel-view render: one full 230x266 image
              through train.runner.render_full_image and
              train.offline.make_hand_eval_render (64 + 64 samples, 4
              up-sample steps), then a few single-chunk requests.  The
              launch counts are zeroed just before and read just after;
              each kernel must have launched, hand_embed_kernel and the
              fused trunk's two (hand_trunk_fwd_kernel,
              hand_uchain_kernel) among them, gemm_tn_kernel,
              uchain_seed_kernel and gemm_kernel not, and the bf16 color
              net's forward (color_fwd_kernel) exactly once a K2 pass (8
              a request, 120 an image);
  4. check    the served pixels are finite, weight_sum lies in
              [0, 1 + 1e-3], and a patch of rays rendered again on the CPU
              (the kernels' plain versions) agrees with the card's;
  5. profile  one request under torch.profiler: device busy against the
              host clock, device time by kernel;
  6. kernel K3  the fine pass's backward against its plain version on
              what one flagship train step hands it (441 rays x 128
              samples = 56,448 points, the loss's cotangents), every
              output (dp, drotT, doff, each dW, db) in L2; then at the
              same points on seeded unit cotangents, held against the
              distance between the plain version on the card and on the
              CPU;
  7. train    the hand model's offline train step
              (train.offline.make_hand_train_step) at the flagship
              configuration: 441 rays, 64 + 64 samples, 4 up-sample steps,
              perturb 1, bf16 trunks, refine_pose on, the auto grad clip,
              vgg_weight 0; 3 warm-up steps, then 20 timed ones.  The
              launch counts are zeroed just before and read just after;
              K1, K2 and K3 must each have launched (and through them
              gemm_tn_kernel, hand_embed_kernel, colsum_partial_kernel,
              the color pair and the trunk's backward pair: a step's
              color_fwd_kernel 2, color_bwd_kernel 1, hand_trunk_ut_kernel
              and hand_trunk_dz_kernel 1 each, gemm_kernel and
              color_dz_kernel 0),
              every loss and grad norm be finite, and se3_refine have
              moved;
  8. train check  one step's metrics and gradient tree on the card
              against the same step on the CPU (plain versions), 64 rays,
              perturb 0;
  9. train profile  one train step under torch.profiler;
  9b. per-point kernels  hand_embed_kernel, colsum_partial_kernel,
              uchain_seed_kernel and fine_bwd_rev_kernel alone at the
              calls one 4096-ray request and one bf16 train step make
              (recorded by running each once through the wrappers,
              record_perpoint_calls): the embedding (bf16; f32 at the
              request's calls; a ragged 70,001 points in both) against
              embed_plain under the kernel rule with its padding exactly
              0, the column sum bit for bit against colsum_ordered_plain,
              within TOL_COLSUM_F64 of f64 and the same bits on a rerun;
              the seed (f32; 1, 7 and 70,001 rows) bit for bit
              against uchain_seed_plain and torch.mul(..., out=); the
              reverse-chain transpose (the step's call; 1, a tile less one
              and 70,001 points, bf16 and f32) against fine_bwd_rev_plain
              under the embedding's rule (f32: TOL_F32), NaN-filled
              outputs, padding exactly 0, dz exactly; ms beside the plain
              versions, the bounds and the library yardsticks (the column
              sum: Z[:m, :N].sum(0); the seed: torch.mul); copy_cols_kernel
              at the calls a 'full_nocolor' and a 'pallas' step make
              (recorded, with their operands' offsets mod 16 bytes: the
              dfeat copy reads dout[:, 1:]) bit for bit against
              copy_cols_plain and torch's copy_, the rest of each
              NaN-filled destination untouched, ms beside
              dst[:, :w].copy_(src[:, :w]) and its bound;
              trunk_pack_e_kernel at a 'pallas' step's and a 'pallas'
              request's recorded calls (pack_calls) bit for bit against
              trunk_pack_e_plain and eb[:, :E].copy_(e), and
              pose_sum_kernel at a step's (pose_calls) bit for bit against
              pose_sum_ordered_plain, on a rerun, within TOL_COLSUM_F64 of
              f64, each timed beside that copy_ / P[:m].sum(0) in CUDA
              graphs (graph_ms) and its bound; then the yardstick of
              reduce_partials_kernel (ws.sum(0)), whose own time comes
              from the profiles; no path calls the u-chain's seed: it is
              timed at the calls the split f32 launches made (an f32
              request's and step's);
  9c. fused trunk  hand_trunk_fwd_kernel and hand_uchain_kernel alone at
              the calls one request and one bf16 'full', 'full_nocolor'
              and 'pallas' step make (record_trunk_calls: K1's sdf
              column, z with and without keep, the recompute's rows;
              the u-chain with u, with keep, and the recompute's without
              u) and at ragged sizes (1 to 65,613 points), every output
              against trunk_fwd_plain / trunk_uchain_plain on the card
              (the kernel rule) and a rerun's bits, timed beside the plain
              version and the bound; the forward's reciprocal against
              __frcp_rn at every f32 in [1, 2]; K1 through fused_hand_sdf
              at 1 to 262,144 points against fused_hand_sdf_plain, each
              call's CUDA graph one hand_embed_kernel and one
              hand_trunk_fwd_kernel a chunk, no GEMM; a request's K2 call's
              graph color_fwd_kernel once a pass, the fused pair once a
              pass, no gemm_kernel and no seed;
  9d. fused color bf16  the bf16 color net as two kernels
              (color_fwd_kernel, its forward: layer 0 over e's and cx2's
              boxes, relu layers in a shared-memory tile, the sigmoid into
              packed; color_bwd_kernel, its transpose: dz = s (1 - s)
              dcolor, the masked layers in place, dx in pieces; bf16 wgmma
              on a TMA ring) at the calls one request and one bf16 'full'
              step make (recorded by phase 9c) and at ragged sizes (1 to
              65,613 points, each output mode): every output (the color
              and the relu rows; dx and the dz rows in f32 and bf16) into
              NaN-filled buffers against the plain versions on the card
              under the kernel rule, a rerun's bits, and the SHA-256 of
              each against the split launches' (one gemm_kernel a layer
              and color_dz_kernel: fused_fine_full._color_fwd_split /
              _color_bwd_split) at the same call, with the relative L2 to
              f64 (color64) within TOL_TRUNK32_VS_SPLIT of the split's
              where bits move; ms of each kernel and of the split
              launches in turns, of the plain versions, beside the bounds;
              each path's calls (a forward a pass of K2 and of K3's
              recompute, a transpose a pass of K3);
  9e. fused trunk backward bf16  the bf16 trunk's backward chains as two
              kernels (hand_trunk_ut_kernel, the u-chain transposed
              upward; hand_trunk_dz_kernel, the forward transposed
              downward; bf16 wgmma on the bf16 trunk's TMA ring) at the
              calls one bf16 'full', 'full_nocolor' and 'pallas' step make
              (recorded by phase 9c: K3's or K6's pass, with the kept rows)
              and at ragged sizes (1 to 65,613 points, with and without
              the kept rows): each chain alone against its plain version
              on the card under the kernel rule (the downward one on the
              plain ds), and through fused_fine.cuda_trunk_backward every
              output (ds, de; with dW the kept dm and dz rows in f32 and
              bf16, each dW and db) against a rerun's bits and the SHA-256
              of the split launches' (one gemm_kernel a layer:
              cuda_trunk_backward_split) at the same call; ms of each
              kernel, of the pair and of the split chain in turns (pair,
              split, split, pair), of the plain versions, beside the
              bounds;
 10. kernel K4  the object SDF (obj_sdf_fused_kernel, one launch a call)
              against its plain version on the card, full-width object
              net of confs/wmask_realobj_bean.conf, at a 65,536-point grid
              chunk, a ragged size and 1,048,576 points, with its time, the
              plain version's, both bounds (the tensor cores' for the sdf
              column's products, the special-function units' for
              softplus's ex2 and lg2) and ms per million points; then the
              256 calls of a 256^3 grid;
 11. obj train  the object model's offline train step
              (train.offline.make_obj_train_step) at the conf as written:
              441 rays, 64 + 64 samples, 4 up-sample steps, perturb 1, f32
              trunks, refine_pose on, vgg_weight 0; 3 warm-up steps, then
              20 timed ones; finite losses, se3_refine moved; one more
              step under torch.profiler;
 12. runner   the object model through train.runner.OfflineRunner, as the
              CLI builds it, on a synthetic 2-view dataset at the conf's
              230x266 in a temporary directory: train(stop_at=10) and a
              checkpoint; a second runner resumes from it, test() writes
              one PNG per view, and validate_mesh(resolution=256) extracts
              a mesh per view through K4 at a threshold between the
              field's value at the box's centre and at its corner (random
              weights have no zero level inside the mesh box).  K4's count
              is zeroed just before the meshes and read just after;
 13. mesh check  the 256^3 grid from K4 against the grid from its plain
              version on the card (the kernel rule), and both through
              marching cubes: vertex and triangle counts within 1%, and
              every K4 vertex within one voxel of the plain mesh
              (chunked torch.cdist on the card); then one 256^3 grid
              under torch.profiler: K4 is one obj_sdf_fused_kernel launch
              a chunk, no GEMM and no embedding kernel.  K4's phase
              profiles 16 grid chunks (a mesh is 256 of them).

The hand's other fine-pass modes (train.fused_fine), between 9 and 10:

 14. kernel K5  the trunk + u-chain on the embedding against its plain
              version, at a flagship 'pallas' step's 56,448 points and a
              request's 524,288 (the elementwise rule);
 15. kernel K6  its backward on what a 'pallas' step hands it, under K3's
              two rules (the step's cotangents in L2; unit cotangents
              against the card-vs-CPU plain distance); the frozen call
              (no weight gradient) gives the same de and launches no dW
              or db kernel (by torch.profiler's kernel names);
 16. kernel K2/K3 no-color  K2 without the color net at a 'full_nocolor'
              step's points and a request's, K3 without it on that step's
              inputs under K3's two rules, and its frozen call;
 17. train pallas  the flagship train step with train.fused_fine =
              'pallas', 3 warm-up and 20 timed steps: K1, K5 and K6
              launched, K2 and K3 not, two packs a step (trunk_pack_e_kernel)
              and no pose sum (a step of 'full' or 'full_nocolor': one, and
              no pack); finite losses, se3_refine moved; one step under
              torch.profiler;
 18. train full_nocolor  the same with 'full_nocolor', 3 + 10 steps: K1, K2
              and K3 launched, K5 and K6 not; one step under torch.profiler
              (in both, copy_cols_kernel launched: its count, COPY, goes
              into the kernels line);
 19. train check pallas  one 64-ray, perturb-0 'pallas' step on the card
              against the CPU (plain versions), the train check's limits;
 20. serve pallas  one 4096-ray request through make_hand_eval_render
              with 'pallas': K1 and K5 launched, K2 and K6 not; the 128 rays
              of it that meet the most surface against the CPU render;
              eight packs (one a K5 pass).

The hand's offline stage with the conf's own f32 trunks (as written;
no ladder kernel unless train.fused_ladder is set), after 20:

 21. f32 GEMMs  gemm_f32_kernel and gemm_tn_f32_kernel alone at the shapes
              of one f32 pass of a flagship step (28,224 points: the
              trunk's layer 0, hidden, skip-concat, last and u-chain
              products, and their dW: gemm_tn_f32_kernel is kept for
              comparison only, no f32 step runs it), against the f64 product
              of the same f32 values (TOL_GEMM_F32_L2 in L2, a single TF32
              product's reading logged beside), the same bits on a rerun,
              the time and TFLOP/s against the 3xTF32 bound and one
              torch.matmul in f32 (TF32 off) as the library yardstick;
 22. kernel K2 f32 request  K2 f32 at one 4096-ray request's 524,288
              points against its plain version (TOL_F32 of the range);
 23. kernel K3 f32  K3 f32 with weight gradients on what one f32 'full'
              train step hands it (56,448 points, two passes, TF32 off):
              every output within TOL_F32 of the plain version's norm in
              L2 (at the kernel's g: the f32 rule's note), with and without
              dW; by torch.profiler's names the fused color pair, the fused
              backward pair and the fused dW launch (trunk_dw_f32_kernel),
              no GEMM of either type, f32 TN GEMM, reduce_partials_kernel,
              colsum_partial_kernel or color_dz_kernel; the last color
              layer's dW read as is (C4);
 24. kernel K2/K3 f32 no-color  K2 f32 without the color net at an f32
              'full_nocolor' step's points (out, g, e within TOL_F32 of the
              range, median and max), K3 f32 without it under the f32 rule;
 25. kernel K5/K6 f32  the same for K5 and K6 at an f32 'pallas' step (K5
              f32 by name: the fused f32 pair, no GEMM);
 26. train f32  the flagship step under 'full', 'full_nocolor', 'pallas' and
              the autograd field, 3 warm-up and 20 timed steps each: the
              launch counts, one step's kernels by name (the fused
              backward pair and dW launch, 'full': the fused color pair; no
              GEMM of either type, f32 TN GEMM, reduce, column sum or
              color_dz_kernel), finite losses, se3_refine moved;
              one 'full' and one 'pallas' step under torch.profiler; two
              pose sums a 'full' and a 'full_nocolor' step, four packs a
              'pallas' one; a step of each mode 4 launches of each f32
              fused forward kernel, 2 of each fused backward one
              (hand_trunk_ut_f32_kernel, hand_trunk_dz_f32_kernel) and 2 of
              trunk_dw_f32_kernel (one a pass; 'full': the color net's
              gradients in it), no seed, no gemm_tn_f32_kernel or
              colsum_partial_kernel, no gemm_f32_kernel or color_dz_kernel,
              and ('full') color_fwd_f32_kernel 4 and color_bwd_f32_kernel
              2 (one a pass of K2, of K3's recompute, of K3's transpose);
              the trunk's and color net's calls of a 'full' and a
              'pallas' step recorded for phases 36-38, a 'full_nocolor'
              step's for 37 and 38;
 26b. per-point kernels f32  the pack at a 'pallas' step's recorded
              calls and the pose sum at a 'full' step's, as in 9b;
 27. train check f32  one 64-ray step per kernel mode, card against CPU;
 28. serve f32  one 4096-ray 'full' request (the eval render's K1
              ladder, whatever the trunk's dtype, as in the JAX package; K2
              f32: 16 passes, the fused f32 pair and color_fwd_f32_kernel 16
              times each, no gemm_f32_kernel, no seed, no backward kernel)
              against the CPU on the 128
              rays that meet the most surface; its trunk calls recorded for
              phase 36.

Pose fitting (the fit confs, f32 trunks), after 13:

 29. kernel K2 f32  K2 in f32 against its plain version (TF32 off) at one
              fit step's 37,632 fine points, within TOL_F32 of the range
              at the median and the max; the plain version with TF32 on
              logged beside;
 30. kernel K3 f32 frozen  the frozen K3 in f32 on that step's inputs and
              cotangents: dp, drotT, doff within TOL_F32 in L2; by
              torch.profiler's names the fused color pair and no GEMM,
              color_dz_kernel or dW/db kernel;
 31. kernel fit modes f32  at what one '12' fit step in 'full_nocolor'
              and in 'pallas' hands its kernels: K2 f32 without the color
              net and K5 f32 under K2's f32 rule, the frozen K3 f32 without
              it and the frozen K6 f32 on the step's cotangents and on
              unit cotangents under the f32 rule;
 31b. per-point kernels fit  fine_bwd_rev_kernel and the pose sum in
              f32 at the calls of phase 30 (one fit step's frozen K3), on
              the step's points, uchain_seed_kernel at the calls the split
              f32 launches made there (none recorded: the fused u-chain
              seeds itself), and the pack at a '12' 'pallas' fit step's
              calls, as in 9b;
 32. fit      the CLI (honerf_torch.cli.fitting_single) '1' then '12' on a
              synthetic catch sequence (1 frame, 8 views, 230x266) with
              random full-width checkpoints, train.iter_num cut to 3: the
              launch counts zeroed before and read after each (K1, K2, K3
              must launch), the pose pickles; then ms per step of each fit
              type (20 after 3 warm-up) and seconds a frame at the
              reference budget;
 33. fit modes  the CLI '12' with train.fused_fine = 'full_nocolor' and
              'pallas' (launch counts, pickle), ms per step, one step's
              kernels by name: f32 GEMMs, no dW / db kernel;
 34. fit check  one 64-ray '12' step on the card against the CPU at
              shared ladder samples: in f32 against the CPU's f64 step,
              the render terms' pose gradients logged on their own;
              on rays that meet the hand head on, card against CPU f32 in
              each fine-pass mode, the render terms' hand-pose gradients
              on their own beside the whole step's; then with K1 (its
              plain version on the CPU) on three batches against f64, with
              K1 held to its plain version at the step's ladder points;
 35. fit profile  one '12' step under torch.profiler.
 36. fused trunk f32  the f32 trunk's two fused kernels
              (hand_trunk_fwd_f32_kernel, then hand_uchain_f32_kernel, 3xTF32
              on wgmma) as pairs at the calls one '12' fit step (recorded
              here), one f32 'full' and 'pallas' step and one f32 request
              (recorded by phases 26 and 28) make, and at ragged sizes (1 to
              65,613 points, every output mode): every output against the
              plain versions on the card under the f32 rule (TOL_F32 of the
              range, median and max), a rerun's bits, the relative L2 to the
              f64 chain beside the split launches' (one gemm_f32_kernel a
              layer and uchain_seed_kernel, fused_fine.cuda_trunk_forward_split)
              at the same call, the pair's worst within TOL_TRUNK32_VS_SPLIT
              of the split's; ms of each kernel, of the split launches and of
              the plain versions beside the bounds; each path's launches of
              gemm_f32_kernel, uchain_seed_kernel, the pair and the backward
              pair against TRUNK32_LAUNCHES (phases 26, 28 and this one count
              them);
 37. fused trunk backward f32  the f32 trunk's backward as two fused
              kernels (hand_trunk_ut_f32_kernel, the u-chain transposed
              upward, then hand_trunk_dz_f32_kernel, the forward transposed
              downward, 3xTF32 on wgmma) at the calls one f32 'full',
              'full_nocolor' and 'pallas' step and one '12' fit step make
              (recorded by phases 26 and 36), and at ragged sizes (1 to
              65,613 points, with and without dW), through
              fused_fine.cuda_trunk_backward: every output (ds, de; with dW
              every kept dm and dz row, each dW and db) into NaN-filled
              buffers against the plain versions on the card under the f32
              rule, a rerun's bits, the relative L2 to the f64 chains
              (trunk_bwd_f64) within TOL_TRUNK32_VS_SPLIT of the split
              launches' (one gemm_f32_kernel a layer,
              fused_fine.cuda_trunk_backward_split); ms of each kernel, of
              the chain against the split chain and the plain chains beside
              the bounds; two calls of the pair a step, one a pass;
 38. fused dW f32  an f32 pass's weight gradients in one launch
              (trunk_dw_f32_kernel, 3xTF32 on wgmma: every trunk dW and db,
              with K3's color net's) at the calls one f32 'full' (with the
              color rows), 'full_nocolor' and 'pallas' step make (recorded
              by phase 26; a fit step, frozen, makes none) and at ragged
              sizes (1 to 65,613 points, with and without the color rows):
              every gradient into NaN-filled buffers against trunk_dw_plain
              on the card under the f32 rule, a rerun's bits, the relative
              L2 to the f64 sums within TOL_TRUNK32_VS_SPLIT of the split
              sequence's (a gemm_tn_f32_kernel and its reduce a product, a
              colsum_partial_kernel a layer: fused_fine.cuda_trunk_dw_split)
              at the same call; ms of the launch and of the split sequence in
              turns, of the plain version, beside the bound; one launch a
              backward pass with dW.
 39. fused color f32  the f32 color net as two kernels
              (color_fwd_f32_kernel, its forward: layer 0 over e's and
              cx2's K ranges, relu layers in shared memory, the sigmoid into
              packed; color_bwd_f32_kernel, its transpose: dz = s (1 - s)
              dcolor, the masked layers, dx in pieces; 3xTF32 on wgmma) at
              the calls one f32 'full' step (recorded by phase 26), one '12'
              fit step (phase 36) and one f32 request (phase 28) make, and at
              ragged sizes (1 to 65,613 points, each output mode): every
              output (the color and the relu rows; dx and the dz rows) into
              NaN-filled buffers against the plain versions on the card
              under the f32 rule, a rerun's bits, the relative L2 to f64
              (color64) within TOL_TRUNK32_VS_SPLIT of the split launches'
              (one gemm_f32_kernel a layer and color_dz_kernel:
              fused_fine_full._color_fwd_split / _color_bwd_split); ms of
              each kernel and of the split launches in turns, of the plain
              versions, beside the bounds; each path's calls (a forward a
              pass of K2 and of K3's recompute, a transpose a pass of K3)
              and launches: gemm_f32_kernel 0, color_dz_kernel 0.

Video fitting, frame-batched fitting and result extraction (the fit
confs' full-width nets, f32; a synthetic 5-frame, 8-view 230x266 catch
sequence, written by a child process started after the build), after 39:

 40. fit batched  the fitting CLI '12' with train.frames_per_batch = 4
              (frames 0-3, then 4; '1''s poses the initial estimates;
              train.iter_num 1): its launch counts (K1, K2, K3 and the f32
              fused kernels launched; no K4, K5, K6, dW, f32 GEMM,
              color_dz_kernel), five pickles; ms per batched step of 4
              frames through the runner, one step's launches, its kernels
              by name (K1's, TFWD32 / TUCH32, CFWD32 / CBWD32, TUT32 / TDZ32;
              no dW or split-launch kernel) and device busy;
 41. video    the CLI honerf_torch.cli.fitting_video '123' and '1234'
              (fit_confs/fit_{123,1234}_8views_0.conf, window 4, 40 rays a
              frame; train.epochs 2, train.sub_iters 1): the same launch
              rules, pose_0 and pose_1 with five pickles each; ms per window
              step through the runner, one step's launches (K2 and K3 once a
              frame), its kernels by name and device busy;
 42. get_res  get_res '12' (64^3 meshes of hand and object, inner ids;
              K1 and K4 launched, no backward kernel), '123' through the CLI
              (inner ids from pose_1), one --render frame of one test view
              (fit_confs/get_render_type12.conf at 8 views: K1 and K2); ms of
              the grid, marching cubes and PLY write of each mesh, the inner
              ids and the render; frame 0's 64^3 grids through K1 and K4
              against their plain versions (mesh_rule: the median, then the
              K4 mesh check's rule at a level inside the box; K1's bf16 mesh:
              99% of its vertices within one voxel, all within two); device
              busy of
              a frame's meshes and of its render;
 43. video check  two '1234' window steps on the card against the CPU
              (video_check_readings: every metric and table gradient under
              the fit check's f64 rule, the six gradients as one within
              TOL_FIT_HEAD_ON of the CPU's, every table update within
              TOL_VIDEO_TABLES), the first step against each frame's single
              fit loss on its own, and the tables against f64 Adam on whole
              tables.

Weights are random (geometric init plus seeded noise, so every embedding
column is live).  check_k3_faults.py runs the kernel, train and fit
checks below on the sound kernels and on planted faults (what each limit
catches).  The last lines of stdout are the card's
`nvidia-smi --query-gpu=name,power.limit` line, a JSON line of per-kernel
numbers (each kernel's other modes beside it: no-color, f32, f32 at a
request, f32 no-color, f32 with dW; the fused trunk's two kernels TFWD
and TUCH at a request's calls, K1's and K2's shares and a bf16 step's;
the f32 pair TFWD32 and TUCH32 at an f32 request's calls, an f32 'full'
and 'pallas' step's and a fit step's, beside the split launches'; the
f32 backward pair TUT32 and TDZ32 at an f32 'full' step's calls, a
'full_nocolor', 'pallas' and fit step's, the chain beside the split one;
the f32 weight gradients' launch TDW32 at an f32 'full' step's calls, a
'full_nocolor' and 'pallas' step's, beside the split sequence's; the f32
color net's pair CFWD32 and CBWD32 at an f32 'full' step's calls, a
request's and a fit step's, beside the split launches'; the bf16 color
net's pair CFWD16 and CBWD16 at a bf16 'full' step's calls and a
request's, beside the split launches';
the bf16 and the f32 GEMMs alone and
the per-point kernels EMBED, COLSUM, UCHAIN, BWDREV, COPY, PACK and POSE
in rows of their own; BWDREV counts launches on every path that runs it:
served images and requests, each train mode, the fit CLI; UCHAIN counts
0 on every path (the fused u-chains seed themselves; its times are taken
at the calls the split f32 launches made); COPY
on the 'full_nocolor' and 'pallas' train paths; PACK on the 'pallas'
step, request and fit; POSE on the 'full' steps and the fit CLI; K4 on the
mesh path, with both bounds and a 256^3 grid's time), and the result line.
Before them, every per-point kernel's launches and device time in each
profiled path (log_perpoint_profiles; a profile that shows
pose_partial_kernel or pose_reduce_kernel, or none that shows
pose_sum_kernel, fails).  Exits nonzero, printing no result, when no CUDA
device is present or a phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
CONF = os.path.join(ROOT, "confs", "wmask_realhand_hand1.conf")
OBJ_CONF = os.path.join(ROOT, "confs", "wmask_realobj_bean.conf")
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core peak
# the special-function units (ex2, lg2, ...): 16 a clock an SM, at the
# card's maximum SM clock (mufu_peak)
MUFU_PER_CLOCK = 16
PEAK_F32_FLOPS = 67e12     # H100 SXM FP32 on the CUDA cores (no tensor cores)
# f32 work on the tensor cores as split-precision 3xTF32 (the f32 GEMMs):
# three TF32 products at 495 TFLOP/s per f32 product
PEAK_F32_3XTF32_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 bandwidth
REQUEST_RAYS = 4096
TRAIN_RAYS = 441            # train.batch_size of the conf
TRAIN_FINE_PTS = TRAIN_RAYS * 128   # its fine points (64 + 64 samples a ray): one K3 pass
N_REQUESTS = 3
CHECK_RAYS = 128
TRAIN_WARMUP, TRAIN_STEPS = 3, 20
NOCOLOR_STEPS = 10          # timed steps of the 'full_nocolor' train phase
MESH_RES = 256              # the CLI's --mode mesh resolution
CHECK_TRAIN_RAYS = 64
FIT_CONFS = {ft: os.path.join(ROOT, "fit_confs", f"fit_{ft}_8views.conf") for ft in ("1", "12")}
FIT_BUDGET = {"1": 30 * 8, "12": 25 * 8}   # the reference's steps a frame: iterations x views
FIT_ITERS = 3               # train.iter_num of the fit phase's CLI runs (cut from 30 / 25)
FIT_CHECK_RAYS = 64
FIT_CHECK_SEEDS = (2, 3, 4)
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
# K3 vs its plain version on a train step's own inputs: each output
# within TOL_K3_L2 of the plain version's norm, in L2.  K2's elementwise
# rule does not hold there: dW, db, drotT and doff sum every point's
# flips (their median reaches 3.0e-4 of the range on other seeds of the
# step), and on one seed flips move dp by up to 2.2e-2 of its range.
# The limit sits between the sound kernel's worst over six seeds (1.7e-2)
# and the smallest planted fault it must catch (6.3e-2).
TOL_K3_L2 = 3e-2
# K3 on seeded unit cotangents at the same points, the card tests' rule:
# each output, in L2, within K3_FACTOR times the distance between the
# plain version on the card and on the CPU (the same bf16 operands, f32
# sums in another order) plus K3_REL of its norm.  This one catches the
# faults of one small output (1% on doff or a color bias) that the real
# step's flips hide.  The card tests hold 4x at random points; at the
# step's points the last color layer's dW sits 10.4x that distance from
# the plain version (0.179 vs 0.0172 of a norm of 70.3), so the factor
# here is 10: that output reads 0.74 of the limit, and the smallest
# planted fault (doff 1% high) ~2.4.  check_k3_faults.py reads both rules
# on the sound kernel and on planted faults (PERF.md, the findings on K3).
K3_FACTOR = 10.0
K3_REL = 1e-3
# Served rays vs the CPU render of the same rays.  A flip in the ladder
# moves a sample by a fraction of its interval, which moves a pixel (the
# JAX package saw 4.7e-2 per pixel between its bf16 ladder kernel and its
# f32 ladder on a full image, BENCH_NOTES.md); most rays agree closely.
# Both outputs lie in [0, 1], so the tolerances are absolute.
TOL_RENDER_MEDIAN = 1e-3
TOL_RENDER_MAX = 1e-1
# One train step on the card vs on the CPU (plain versions), 64 rays,
# perturb 0: each loss term relative to its value, each gradient leaf
# as |card - cpu| / |cpu| (L2).  Flips in the bf16 ladder move samples,
# as in the check phase.  Sound kernels, seeds 1-4 of the batch: loss
# terms up to 2.9e-3, leaves up to 9.0e-2; the smallest planted faults
# this catches: 0.109 (loss), 0.48 (leaf).
TOL_TRAIN_LOSS = 1e-2
TOL_TRAIN_GRAD = 2e-1
# K2 in f32 and K3 in f32 with frozen nets (pose fitting) vs their plain
# versions on the card with TF32 off: the same f32 operands and f32 sums
# in another order (~1e-6 of the range expected), so K2's outputs within
# TOL_F32 of the range at the median and at the max, K3's dp, drotT and
# doff within TOL_F32 of the plain version's norm in L2.  A TF32 product
# (a 10-bit mantissa) would sit well above: the phase logs the plain
# version's own distance with TF32 on.
TOL_F32 = 1e-4
# One '12' fit step on the card vs on the CPU, the same inputs, weights
# and pose, perturb 0, every side at the card's ladder samples: the loss
# terms (relative) and the six pose gradients (relative, L2), against the
# CPU's f64 step.  f32 rounding alone moves the render terms' (color,
# mask) hand-pose gradients by 2e-3-5e-2 on these random full-width
# fields, on random rays (fit_batch) and on rays that meet the hand head on
# (fit_grid_batch) alike (the CPU's f32 step against its f64 one; the
# phase logs it per term), and the hand's whole pose gradient by 3-5% on
# random rays, so the JAX suite's 1e-3 cannot hold against anything f32
# there: the f64 rule holds the card within FIT_FACTOR x the CPU's own f32
# distance from f64 plus TOL_FIT_F32, the whole step and the render terms'
# hand-pose gradients.  On head-on rays the card's f32 step and the CPU's
# agree far better than either agrees with f64, and the card is held to
# the CPU's f32 step directly, in each fine-pass mode: the whole pose
# gradient (mostly the joint term; f32 within 6e-6 of f64 there) within
# TOL_FIT_HEAD_ON, and each render term's hand-pose gradient within
# TOL_FIT_RENDER (the sound kernels read 3.4e-4; a drotT without one term
# 4.7e-3, doff 1% high or K6's du unscaled at the skip ~9.7e-3).  Faults
# whose cotangent is near zero at a fit step (e's, in the no-color mode)
# show only in the kernel phases, at the step's own inputs and on unit
# cotangents (check_k3_faults.py, PERF.md).
# With K1 the card's first K1 call of the step is held to K1's plain
# version at its own points under the kernel rule (TOL_MEDIAN, TOL_MAX of
# the range): comparing the two ladders' samples cannot see a shifted sdf
# (the coarse samples, the object's and most of the hand's are the same on
# both sides, and a bf16 flip moves one by up to 0.1); every side then
# renders at the card's samples and the card is held to the f64 rule: on
# some seeded poses HALO's f32 chain alone moves the joint term's pose
# gradient by ~1e-3 (seed 3: palm_angle, the CPU's f32 step against its
# f64 one).
# The f32 rule for K3 with the color net at a step's points: the color
# net's input holds sin / cos(2^l g) of the spatial gradient g, and |g| reaches
# hundreds on a random field, so the kernel's g and the plain version's
# (each within ~3e-5 of g's range) move that input, and the color net's
# dW with it, by up to ~1e-2 of its norm; where a color relu's
# pre-activation sits within ~1e-6 of its row's scale of zero, two f32
# sums in another order can flip its mask.  So the f32 rule holds K3
# against its plain version at the kernel's own g (the plain version's
# g_color), with dcolor zero at the points within FF.RELU_MARGIN of a kink
# (FF.shared_g_cotangents; ~0.1% of them).  The phase logs the last color
# layer's dW as is beside it (PERF.md, C4).
# One f32 train step (the conf's own trunks, no ladder kernel) on the card
# vs on the CPU, per fine-pass mode, 64 rays, perturb 0: the worst loss
# term and the worst gradient leaf as in the bf16 train check; the limits
# sit between the sound kernels' readings and the planted faults'
# (check_k3_faults.py, PERF.md).
TOL_TRAIN_F32_LOSS = 1e-3
TOL_TRAIN_F32_GRAD = 1e-2
# The f32 GEMMs alone (gemm_f32_kernel, gemm_tn_f32_kernel), at one f32
# pass of a flagship step (28,224 points: 56,448 in two), against the f64
# product of the same f32 values: |kernel - f64| / |f64| in L2.  3xTF32
# with a fresh accumulator per K step reads 2.5-3.0e-7 (cuBLAS's f32
# 2.9-8.7e-7 at these shapes); a single TF32 product 2.9e-4 (logged
# beside: torch.matmul with TF32 on).  The limit sits between the two.
F32_GEMM_M = 28224
# (K1, K2, N, a_scale): layer 0, a hidden layer, the skip concat, the last
# layer, a u-chain step into the embedding columns
F32_GEMM_SHAPES = ((1408, 0, 256, 0.0), (256, 0, 256, 0.0), (256, 1408, 256, 0.70710678),
                   (256, 0, 320, 0.0), (256, 0, 1408, 0.0))
# (K, N, x_scale) of dW = (x_scale X)^T Y over the points: layer 0, a
# hidden layer, the skip's embedding rows, the last layer
F32_TN_SHAPES = ((1408, 256, 0.0), (256, 256, 0.0), (1408, 256, 0.70710678), (256, 320, 0.0))
TOL_GEMM_F32_L2 = 1e-5
# The bf16 GEMMs alone (gemm_kernel, gemm_tn_kernel: wgmma on a TMA ring),
# at a bf16 pass's M (65,536 points), against the f64 sum of the same bf16
# operands: |kernel - f64| / |f64| in L2.  The tensor core adds each k16
# product into its f32 accumulator rounding toward zero, so the sums drift
# with K: PR 2's WMMA mainloop read 1.40e-6 at K 1408 (bench_gemm.py;
# cuBLAS f32 3.05e-7), and the limit is 1.5x that.  The dW products sum
# each K stage (64 points) into fresh accumulators, added into the running
# sums with round to nearest (summed straight into one accumulator, a
# ~5,500-point split read 6e-6).
BF16_GEMM_M = 65536
# (K1, K2, N, a_scale): F32_GEMM_SHAPES with the skip's bf16(1/sqrt2),
# and the color net's input, the embedding + 256 features / grad-PE
BF16_GEMM_SHAPES = tuple((k1, k2, n, 0.70703125 if s else 0.0)
                         for k1, k2, n, s in F32_GEMM_SHAPES) + ((1408, 256, 256, 0.0),)
BF16_TN_SHAPES = tuple((k, n, 0.70703125 if s else 0.0) for k, n, s in F32_TN_SHAPES)
TOL_GEMM_BF16_L2 = 1.5 * 1.40e-6
# The column sum (db) alone, against the f64 sum of the same f32 values
# (seeded normal rows, ~5.6e4 of them: sums of size ~240, whose f32
# rounding noise is ~1e-4); the card tests' limit.  Its bits are held to
# colsum_ordered_plain exactly.
TOL_COLSUM_F64 = 1e-3
FIT_FACTOR = 4.0
TOL_FIT_F32 = 1e-3
TOL_FIT_HEAD_ON = 1e-4
TOL_FIT_RENDER = 1e-3
FIT_RENDER_TERMS = ("color", "mask")

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


def mufu_peak(torch):
    """The special-function units' peak, operations a second: MUFU_PER_CLOCK
    x the card's SMs x its maximum SM clock as nvidia-smi reads it
    (clocks.max.sm); and that clock in MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return MUFU_PER_CLOCK * sms * mhz * 1e6, mhz


def err_readings(torch, got, want, scale=None):
    """(median, p99, max) of |got - want| over every element, and the
    output's range (max |want| unless given)."""
    err = (got.float() - want.float()).abs().flatten()
    if scale is None:
        scale = max(float(want.abs().max()), 1e-6)
    if err.numel() < 1 << 24:
        med, p99 = (float(torch.quantile(err, q)) for q in (0.5, 0.99))
    else:  # past torch.quantile's size limit: the order statistics
        srt = err.sort().values
        med, p99 = (float(srt[int(q * (err.numel() - 1))]) for q in (0.5, 0.99))
    return med, p99, float(err.max()), scale


def compare(torch, what: str, got, want, tol_median=TOL_MEDIAN, tol_max=TOL_MAX, scale=None):
    """(ok, max abs error, text): median and max of |got - want| over
    every element against tol_median / tol_max times the output's range
    (max |want| unless given)."""
    med, p99, mx, scale = err_readings(torch, got, want, scale)
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


def k5_flops(cfg, n: float) -> float:
    """Trunk forward + u-chain (transposed matmuls, layers n-2..0) on n
    points: K5's operations, and the trunk's share of K2's."""
    trunk = trunk_dims(cfg, cfg.d_out)
    fwd = sum(i * o for i, o in trunk)
    uchain = sum(cfg.d_hidden * i for i, _ in trunk[:-1])
    return 2.0 * n * (fwd + uchain)


def k2_flops(cfg, ccfg, n: float) -> float:
    """K5's products + the color net, on n points."""
    cd = ccfg.dims
    color = sum(cd[l] * cd[l + 1] for l in range(len(cd) - 1))
    return k5_flops(cfg, n) + 2.0 * n * color


def k3_flops(cfg, ccfg, n: float) -> float:
    """The forward recomputed (K2's products), then for each product its
    transpose (the cotangent of its input) and its dW = X^T dY: three
    times K2's operations."""
    return 3.0 * k2_flops(cfg, ccfg, n)


def _last_layer_flops(cfg, n: float) -> float:
    i, o = trunk_dims(cfg, cfg.d_out)[-1]
    return 2.0 * n * i * o


def k3_nocolor_flops(cfg, n: float) -> float:
    """K3 without the color net: three times K5's products, less the
    recompute's last layer, whose output (out) the backward does not
    read; the u-chain's embedding columns (u) it does read."""
    return 3.0 * k5_flops(cfg, n) - _last_layer_flops(cfg, n)


def k6_flops(cfg, n: float) -> float:
    """K6: three times K5's products, less the recompute's products whose
    outputs the VJP does not read, because it is given the cotangents on
    them: the last layer (out) and the u-chain's embedding columns (u),
    that is the chain's layer-0 product and the skip layer's E columns."""
    trunk = trunk_dims(cfg, cfg.d_out)
    n_emb = 1 + sum(1 for l in range(1, len(trunk)) if l in cfg.skip_in)
    return (3.0 * k5_flops(cfg, n) - _last_layer_flops(cfg, n)
            - 2.0 * n * n_emb * cfg.d_hidden * cfg.input_width)


def k3_frozen_flops(cfg, ccfg, n: float) -> float:
    """The products the frozen K3 launches (no weight gradient): the
    forward recomputed whole (K2's products: the trunk, the u-chain with
    its embedding columns, the color net), then the color net transposed
    (each color product once more), the u-chain transposed upward (each
    u-chain product once more) and the trunk forward transposed downward
    (each trunk product once more); no dW = X^T dY."""
    trunk = trunk_dims(cfg, cfg.d_out)
    cd = ccfg.dims
    color_t = 2.0 * n * sum(cd[l] * cd[l + 1] for l in range(len(cd) - 1))
    uchain_t = 2.0 * n * sum(cfg.d_hidden * i for i, _ in trunk[:-1])
    trunk_t = 2.0 * n * sum(i * o for i, o in trunk)
    return k2_flops(cfg, ccfg, n) + color_t + uchain_t + trunk_t


def k4_flops(obj_cfg, n: float) -> float:
    """The object SDF forward (shrink skip) on n points, counting the sdf
    column of the last layer only: the function returns nothing else (the
    TPU kernel wrote 128 columns and kept column 0)."""
    d, E = obj_cfg.dims, obj_cfg.input_width
    last = len(d) - 2
    return 2.0 * n * sum(
        d[l] * (1 if l == last else d[l + 1] - (E if l + 1 in obj_cfg.skip_in else 0))
        for l in range(last + 1))


def k4_mufu_ops(obj_cfg, n: float) -> float:
    """The special-function operations of the object SDF forward on n
    points: softplus's two (ex2 and lg2) on each hidden layer's outputs."""
    d = obj_cfg.dims
    last = len(d) - 2
    return 2.0 * n * sum(d[l + 1] - (obj_cfg.input_width if l + 1 in obj_cfg.skip_in else 0)
                         for l in range(last))


def clone_tree(tree, device):
    if isinstance(tree, dict):
        return {k: clone_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v, device) for v in tree]
    return tree.detach().to(device).clone()


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def trace_groups(evts):
    """A trace's device events by kernel name (ours bare, torch's prefixed
    "torch: "), each [us, launches], and their busy us: the union of
    their intervals."""
    groups, spans = {}, []
    for evt in evts:
        tr = evt.time_range
        spans.append((tr.start, tr.end))
        name = evt.name.split("(")[0].replace("void ", "").replace("honerf::", "")
        name = name.replace("__nv_bfloat16", "bf16")
        if "honerf" not in evt.name:
            name = "torch: " + name[:60]
        g = groups.setdefault(name, [0.0, 0])
        g[0] += tr.elapsed_us()
        g[1] += 1
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + b - a, b
        elif b > end:
            busy, end = busy + b - end, b
    return groups, busy


def device_profile(torch, label: str, fn, points=None):
    """fn() once under torch.profiler: host-clock time, device busy (the
    union of the device's kernel intervals) and device time by kernel;
    returns the host-clock and busy ms (None without device time).  The
    kernels by name go into PROFILES[label], with `points`, the points a
    launch of the path's per-point kernels takes (log_perpoint_profiles'
    bounds)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    evts = [evt for evt in prof.events() if evt.device_type == DeviceType.CUDA]
    if not evts:
        log(f"profile: {label}: the profiler recorded no device time (not measured)")
        return None
    groups, busy = trace_groups(evts)
    PROFILES[label] = (groups, points)
    kern = sum(g[0] for g in groups.values())
    log(f"profile: {label}, {wall_us / 1e3:.1f} ms on the host clock; device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%), kernel time {kern / 1e3:.1f} ms in "
        f"{len(evts)} launches")
    for name, (us, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"  {us / 1e3:8.2f} ms {100 * us / kern:5.1f}%  x{cnt:<5d} {name}")
    return wall_us / 1e3, busy / 1e3


def device_capture(torch, fn, tries: int = 3):
    """fn()'s device events (torch.profiler) and its host-clock ms; no
    events (and None) when the profiler records no device time.  The
    device's tracing starts after the profiler does: kernels that run in
    its first milliseconds can go unrecorded (on an H100 one capture lost
    K6's first 45 of 113), so the profiler runs a warm-up step first (its
    schedule's, whose records it drops: a ~5 ms spin kernel) and records
    the step that follows, in which another spin kernel (not counted) runs
    before fn().  A capture that records no device kernel at all (late in
    the script's process one lost K5 f32's whole call) is taken again, up
    to `tries` captures.  The step's own span (ProfilerStep#n, which the
    trace lists on the device's timeline too) is not one of fn()'s
    events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as torch_profile

    host_ms = None
    for _ in range(tries):
        traces = []
        with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                           schedule=schedule(wait=0, warmup=1, active=1),
                           on_trace_ready=lambda p: traces.append(p.events())) as prof:
            for step in range(2):
                torch.cuda.synchronize()
                torch.cuda._sleep(10_000_000)   # ~5 ms of device time
                torch.cuda.synchronize()
                if step:
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    host_ms = (time.perf_counter() - t0) * 1e3
                prof.step()
        evts = [e for e in (traces[-1] if traces else ())
                if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.name
                and not e.name.startswith("ProfilerStep")]
        if evts:
            return evts, host_ms
    return [], None


def device_kernel_names(torch, fn, tries: int = 3):
    """Counter of the device kernels fn() launches, by name (device_capture);
    empty when the profiler records no device time.  Where the call can be
    captured in a CUDA graph, graph_kernel_nodes counts its launches with
    nothing to lose."""
    from collections import Counter

    return Counter(e.name.split("(")[0] for e in device_capture(torch, fn, tries)[0])


def graph_kernel_nodes(torch, fn):
    """The nodes of a CUDA graph captured from fn(), each as its label in
    CUDA's dump of it (torch's CUDAGraph.debug_dump, cudaGraphDebugDotPrint):
    every launch and copy the call issues on its stream, counted by CUDA
    and not by a wrapper's counter, with no trace to lose.  fn must have
    run once before (a first call's one-time set-up)."""
    import re
    import warnings

    g = torch.cuda.CUDAGraph(keep_graph=True)   # the graph kept for its dump
    g.enable_debug_mode()
    with torch.cuda.graph(g):
        fn()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(ROOT, "build", "graph_kernel_nodes.dot")
    with warnings.catch_warnings():   # torch warns that it dumps
        warnings.simplefilter("ignore")
        g.debug_dump(path)
    with open(path) as f:
        dot = f.read()
    os.remove(path)
    g.reset()
    return re.findall(r'"graph_\d+_node_\d+"\s*\[[^\]]*?label="(.*?)"\]', dot, re.S)


def nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops: float, n_bytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak, n_bytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes")


def f32_gemm_readings(torch, dev, timed: bool = True):
    """Both f32 GEMMs alone at F32_GEMM_SHAPES / F32_TN_SHAPES (M =
    F32_GEMM_M points, seeded normal operands, B scaled by 1/sqrt(K)):
    per shape |kernel - f64| / |f64| in L2 and max |kernel - f64|, the
    same bits on a rerun, a single TF32 product's L2 (torch.matmul with
    TF32 on); timed: the kernel's ms, one torch.matmul's (TF32 off, the
    library yardstick; the port never calls it) and the 3xTF32 bound."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF
    from honerf_torch.ops import fused_hand as FH

    lib = FF._bwd_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(11)
    M = F32_GEMM_M
    ws = torch.empty((FT._WS_FLOATS,), device=dev)
    out = []

    def reading(what, run, res, exact, lib_fn, flops, n_bytes):
        run()
        got = res.clone()
        run()
        again = res.clone()
        torch.cuda.synchronize()
        err = got.double() - exact
        l2 = float(err.norm() / exact.norm())
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32_l2 = float((lib_fn().double() - exact).norm() / exact.norm())
        torch.backends.cuda.matmul.allow_tf32 = False
        r = SimpleNamespace(what=what, l2=l2, max_abs=float(err.abs().max()),
                            same=bool(torch.equal(got, again)), tf32_l2=tf32_l2, flops=flops,
                            ms=None, lib_ms=None, bound_ms=None, bound_by=None)
        r.ok = r.same and l2 <= TOL_GEMM_F32_L2
        if timed:
            r.ms = cuda_ms(torch, run, 10)
            r.lib_ms = cuda_ms(torch, lib_fn, 10)
            r.bound_ms, r.bound_by = bound(flops, n_bytes, PEAK_F32_3XTF32_FLOPS)
        out.append(r)

    for K1, K2, N, a_scale in F32_GEMM_SHAPES:
        K = K1 + K2
        A1 = torch.randn((M, K1), generator=gen, device=dev)
        A2 = torch.randn((M, K2), generator=gen, device=dev) if K2 else None
        B = torch.randn((K, N), generator=gen, device=dev) / K ** 0.5
        C = torch.empty((M, N), device=dev)
        A = A1 if A2 is None else torch.cat([A1, A2], dim=1)
        if a_scale:
            A = A * a_scale

        def run(A1=A1, K1=K1, A2=A2, K2=K2, B=B, N=N, C=C, a_scale=a_scale):
            FH.gemm(lib, A1, K1, A2, K2, B, N, None, M, FH.EPI_F32, C, N, n_store=N,
                    a_scale=a_scale, stream=stream)

        reading(f"gemm_f32 K {K1}{f' + {K2}' if K2 else ''}{' scaled' if a_scale else ''} "
                f"N {N}", run, C, A.double() @ B.double(), lambda A=A, B=B: A @ B,
                2.0 * M * K * N, 4 * (M * K + K * N + M * N))
    for K, N, x_scale in F32_TN_SHAPES:
        X = torch.randn((M, K), generator=gen, device=dev)
        Y = torch.randn((M, N), generator=gen, device=dev) / M ** 0.5
        dW = torch.empty((K, N), device=dev)
        Xs = X * x_scale if x_scale else X

        def run(X=X, K=K, Y=Y, N=N, dW=dW, x_scale=x_scale):
            FT._tn(lib, X, K, K, Y, N, M, dW, 0, ws, stream, x_scale=x_scale)

        reading(f"gemm_tn_f32 K {K} N {N}{' scaled' if x_scale else ''}", run, dW,
                Xs.double().T @ Y.double(), lambda Xs=Xs, Y=Y: Xs.T @ Y, 2.0 * M * K * N,
                4 * (M * K + M * N + K * N))
    return out


def bf16_gemm_readings(torch, dev, timed: bool = True):
    """Both bf16 GEMMs alone at BF16_GEMM_SHAPES / BF16_TN_SHAPES (M =
    BF16_GEMM_M points, seeded normal bf16 operands, B scaled by
    1/sqrt(K)), the NN product read through the EPI_F32 epilogue: per
    shape |kernel - f64| / |f64| in L2, max |kernel - f64|, the mean
    shrink (|kernel| - |f64|) / rms |f64|, the same bits on a rerun;
    timed: the kernel's ms, its plain version's (the f32 product of the
    bf16 values), one bf16 torch.matmul's (the library yardstick; the port
    never calls it) and the bound."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF
    from honerf_torch.ops import fused_hand as FH

    lib = FF._bwd_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(13)
    M = BF16_GEMM_M
    ws = torch.empty((FT._WS_FLOATS,), device=dev)
    bf = torch.bfloat16
    out = []

    def reading(what, run, res, exact, plain_fn, lib_fn, flops, n_bytes):
        run()
        got = res.clone()
        run()
        again = res.clone()
        torch.cuda.synchronize()
        err = got.double() - exact
        l2 = float(err.norm() / exact.norm())
        shrink = float((got.double().abs() - exact.abs()).mean() / exact.pow(2).mean().sqrt())
        r = SimpleNamespace(what=what, l2=l2, max_abs=float(err.abs().max()), shrink=shrink,
                            same=bool(torch.equal(got, again)), flops=flops, ms=None,
                            plain_ms=None, lib_ms=None, bound_ms=None, bound_by=None)
        r.ok = r.same and l2 <= TOL_GEMM_BF16_L2 and bool(torch.isfinite(got).all())
        if timed:
            r.ms = cuda_ms(torch, run, 10)
            r.plain_ms = cuda_ms(torch, plain_fn, 10)
            r.lib_ms = cuda_ms(torch, lib_fn, 10)
            r.bound_ms, r.bound_by = bound(flops, n_bytes)
        out.append(r)

    for K1, K2, N, a_scale in BF16_GEMM_SHAPES:
        K = K1 + K2
        A1 = torch.randn((M, K1), generator=gen, device=dev).to(bf)
        A2 = torch.randn((M, K2), generator=gen, device=dev).to(bf) if K2 else None
        B = (torch.randn((K, N), generator=gen, device=dev) / K ** 0.5).to(bf)
        C = torch.empty((M, N), device=dev)
        A = A1 if A2 is None else torch.cat([A1, A2], dim=1)
        if a_scale:
            A = (A.float() * a_scale).to(bf)   # the skip concat's rounding

        def run(A1=A1, K1=K1, A2=A2, K2=K2, B=B, N=N, C=C, a_scale=a_scale):
            FH.gemm(lib, A1, K1, A2, K2, B, N, None, M, FH.EPI_F32, C, N, n_store=N,
                    a_scale=a_scale, stream=stream)

        reading(f"gemm K {K1}{f' + {K2}' if K2 else ''}{' scaled' if a_scale else ''} N {N}",
                run, C, A.double() @ B.double(), lambda A=A, B=B: A.float() @ B.float(),
                lambda A=A, B=B: A @ B, 2.0 * M * K * N, 2 * (M * K + K * N) + 4 * M * N)
    for K, N, x_scale in BF16_TN_SHAPES:
        X = torch.randn((M, K), generator=gen, device=dev).to(bf)
        Y = (torch.randn((M, N), generator=gen, device=dev) / M ** 0.5).to(bf)
        dW = torch.empty((K, N), device=dev)
        Xs = (X.float() * x_scale).to(bf) if x_scale else X

        def run(X=X, K=K, Y=Y, N=N, dW=dW, x_scale=x_scale):
            FT._tn(lib, X, K, K, Y, N, M, dW, 0, ws, stream, x_scale=x_scale)

        reading(f"gemm_tn K {K} N {N}{' scaled' if x_scale else ''}", run, dW,
                Xs.double().T @ Y.double(), lambda Xs=Xs, Y=Y: Xs.float().T @ Y.float(),
                lambda Xs=Xs, Y=Y: Xs.T @ Y, 2.0 * M * K * N, 2 * (M * K + M * N) + 4 * K * N)
    return out


def embed_flops(vL: int, rL: int) -> float:
    """FLOP of one point's embedding row as hand_embed_kernel forms it (each
    sqrt, exp, rsqrt, division, sin and cos counted as one): 21 bone stages
    (~35), 21 v-parts (3 + 5 (vL - 1) + 2 vL) and 63 r-parts (4 + 5 (rL -
    1) + 2 rL); ~5.2 kFLOP at vL 10, rL 7."""
    return 21 * 35 + 21 * (3 + 5 * (vL - 1) + 2 * vL) + 63 * (4 + 5 * (rL - 1) + 2 * rL)


def record_perpoint_calls(fn):
    """Run fn() once with the per-point kernels' wrappers recording their
    calls, in launch order: .embed [(m, vL, rL, lde, dtype)], .colsum
    [(N, m, ldz)], .seed [(m, width, ldt, dtype)] (the u-chain's seed),
    .bwdrev [(m, meta, ldx, lddu, lddz)] (K3's reverse-chain transpose),
    .copy [(m, width, src dtype, lds, ldd, src and dst offsets mod 16 bytes
    in elements)] (copy_cols), .tn [(K, N, m,
    dtype)] (the dW products, whose partials reduce_partials_kernel
    sums), .pack [(m, E, lde, ldo, eb dtype, e's offset mod 16 bytes in
    elements)] (trunk_pack_e, K5 / K6's operand) and .pose [(m, acc)]
    (K3's pose sums)."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF
    from honerf_torch.ops import fused_hand as FH

    rec = SimpleNamespace(embed=[], colsum=[], seed=[], bwdrev=[], copy=[], tn=[], pack=[],
                          pose=[])
    # (a package from before the seed's, the transpose's, the pack's and the
    # pose sum's wrappers lacks them)
    embed, colsum, copy, tn = FH.embed, FT._colsum, FT.copy_cols, FT._tn
    seed, bwdrev = getattr(FT, "uchain_seed", None), getattr(FF, "fine_bwd_rev", None)
    pack, pose = getattr(FT, "trunk_pack_e", None), getattr(FF, "pose_sum", None)

    def rec_embed(lib, pts, m, rotT, off, cut, vL, rL, e, stream):
        rec.embed.append((m, vL, rL, e.shape[1], e.dtype))
        return embed(lib, pts, m, rotT, off, cut, vL, rL, e, stream)

    def rec_colsum(lib, Z, N, m, out, acc, ws, stream):
        rec.colsum.append((N, m, Z.stride(0)))
        return colsum(lib, Z, N, m, out, acc, ws, stream)

    def rec_seed(lib, w, s_, m, t, stream):
        rec.seed.append((m, s_.shape[1], t.stride(0), t.dtype))
        return seed(lib, w, s_, m, t, stream)

    def rec_bwdrev(blib, pts, m, rotT, off, cut, meta, packed, dsdf, dg, dx, du_b, du_s, dgt,
                   dzf, dzb, stream):
        rec.bwdrev.append((m, meta, dx.stride(0), du_b.stride(0), dzf.stride(0)))
        return bwdrev(blib, pts, m, rotT, off, cut, meta, packed, dsdf, dg, dx, du_b, du_s, dgt,
                      dzf, dzb, stream)

    def rec_copy(lib, src, m, width, dst, stream):
        rec.copy.append((m, width, src.dtype, src.stride(0), dst.stride(0),
                         src.data_ptr() % 16 // src.element_size(), dst.data_ptr() % 16 // 4))
        return copy(lib, src, m, width, dst, stream)

    def rec_tn(lib, X, ldx, K, Y, N, m, out, acc, ws, stream, x_scale=0.0):
        rec.tn.append((K, N, m, X.dtype))
        return tn(lib, X, ldx, K, Y, N, m, out, acc, ws, stream, x_scale)

    def rec_pack(lib, e, m, eb, stream):
        rec.pack.append((m, e.shape[1], e.stride(0), eb.stride(0), eb.dtype,
                         e.data_ptr() % 16 // 4))
        return pack(lib, e, m, eb, stream)

    def rec_pose(blib, P, m, out, acc, ws, stream):
        rec.pose.append((m, acc))
        return pose(blib, P, m, out, acc, ws, stream)

    patched = ((FH, "embed", rec_embed), (FT, "_colsum", rec_colsum), (FF, "_colsum", rec_colsum),
               (FT, "uchain_seed", rec_seed), (FF, "fine_bwd_rev", rec_bwdrev),
               (FT, "copy_cols", rec_copy), (FT, "_tn", rec_tn), (FF, "_tn", rec_tn),
               (FT, "trunk_pack_e", rec_pack), (FF, "pose_sum", rec_pose))
    patched = [(mod, name, f) for mod, name, f in patched if hasattr(mod, name)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patched]
    for mod, name, f in patched:
        setattr(mod, name, f)
    try:
        fn()
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    return rec


def _tally(calls):
    """{call: how many times} in first-seen order."""
    out = {}
    for c in calls:
        out[c] = out.get(c, 0) + 1
    return out


def perpoint_pose(torch, dev, n: int = 131072):
    """The flagship's pose operands (rotT, off, cut) at posed_hand_example's
    joints and n seeded points near them, as main() makes them."""
    import numpy as np

    from honerf_torch.data.synthetic import canonical_hand_joints, posed_hand_example
    from honerf_torch.hand import bone_transforms_from_mano_joints
    from honerf_torch.ops import fused_hand as FH

    joints = posed_hand_example()[0]
    bt_inv = bone_transforms_from_mano_joints(torch.as_tensor(joints, device=dev)[None])[0]
    pose = FH.pack_hand_pose(bt_inv, torch.as_tensor(canonical_hand_joints(0.0), device=dev))
    rng = np.random.default_rng(0)
    pts = joints[rng.integers(0, 21, n)] + rng.normal(size=(n, 3)) * 0.05
    return pose, torch.as_tensor(pts.astype(np.float32), device=dev)


def perpoint_calls(torch):
    """Calls of the per-point kernels that the main path's shapes (all
    multiples of a tile's points) leave out or that stand for them: the
    embedding at a ragged 70,001 points in bf16 and f32 and at a K1 pass's
    131,072 (the flagship's vL 10, rL 7, lde 1408); the column sum at a
    bf16 step's 56,448 rows of a 320-wide dz, N 64, 256 and 320."""
    return ([(70001, 10, 7, 1408, torch.bfloat16), (70001, 10, 7, 1408, torch.float32),
             (131072, 10, 7, 1408, torch.bfloat16)],
            [(N, 56448, 320) for N in (64, 256, 320)])


def perpoint_readings(torch, dev, pose, pts, embed_calls, colsum_calls, timed: bool = True):
    """hand_embed_kernel and colsum_partial_kernel alone at the recorded
    calls (record_perpoint_calls), each distinct shape once, weighted by
    its count.  EMBED: into a NaN-filled e of the call's rows, against
    embed_plain on the same card inputs (the kernel rule: TOL_MEDIAN,
    TOL_MAX of the range; the padding columns exactly 0).  COLSUM: on a
    seeded normal Z of the call's shape, the same bits as
    colsum_ordered_plain on the card, within TOL_COLSUM_F64 of the f64 sum,
    the same bits on a rerun.  timed: ms of the kernel, its plain version,
    its bound and (COLSUM) one `Z[:m, :N].sum(0)`, the library yardstick
    (the port never calls it).  Returns (embed readings, colsum readings)."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF
    from honerf_torch.ops import fused_hand as FH

    rotT, off, cut = pose
    lib, blib = FH._lib("fused_hand"), FF._bwd_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = torch.empty((FT._WS_FLOATS,), device=dev)
    emb, cols = [], []
    for (m, vL, rL, lde, dtype), count in _tally(embed_calls).items():
        e = torch.full((m, lde), float("nan"), device=dev, dtype=dtype)

        def run(m=m, vL=vL, rL=rL, e=e):
            FH.embed(lib, pts, m, rotT, off, cut, vL, rL, e, stream)

        def plain(m=m, vL=vL, rL=rL, lde=lde, dtype=dtype):
            return FH.embed_plain(pts[:m], rotT, off, cut, vL, rL, lde, dtype)

        run()
        want = plain()
        torch.cuda.synchronize()
        E = 21 * (1 + 2 * vL) + 63 * (1 + 2 * rL)
        ok, mx, text = compare(torch, "e", e, want)
        pad_ok = bool((e[:, E:] == 0).all())
        r = SimpleNamespace(m=m, dtype=str(dtype).split(".")[-1], count=count, max_abs=mx,
                            ok=ok and pad_ok, text=text + ("" if pad_ok else "; padding FAIL"),
                            ms=None, plain_ms=None, bound_ms=None, bound_by=None)
        if timed:
            r.ms = cuda_ms(torch, run, 10)
            r.plain_ms = cuda_ms(torch, plain, 2)
            n_bytes = m * lde * e.element_size() + 12 * m + nbytes([rotT, off, cut])
            r.bound_ms, r.bound_by = bound(m * embed_flops(vL, rL), n_bytes, PEAK_F32_FLOPS)
        del e, want
        emb.append(r)
    gen = torch.Generator(device=dev).manual_seed(17)
    for (N, m, ldz), count in _tally(colsum_calls).items():
        Z = torch.randn((m, ldz), generator=gen, device=dev)
        res = torch.full((N,), float("nan"), device=dev)

        def run(Z=Z, N=N, m=m, res=res):
            FT._colsum(blib, Z, N, m, res, 0, ws, stream)

        run()
        got = res.clone()
        run()
        again = res.clone()
        want = FT.colsum_ordered_plain(Z, N, m)
        f64 = float((got.double() - Z[:m, :N].double().sum(0)).abs().max())
        torch.cuda.synchronize()
        same, rerun = bool(torch.equal(got, want)), bool(torch.equal(got, again))
        r = SimpleNamespace(N=N, m=m, ldz=ldz, count=count, same=same, rerun=rerun, f64=f64,
                            max_abs=float((got - want).abs().max()),
                            ok=same and rerun and f64 <= TOL_COLSUM_F64, ms=None, plain_ms=None,
                            lib_ms=None, bound_ms=None, bound_by=None)
        if timed:
            r.ms = cuda_ms(torch, run, 20)
            r.plain_ms = cuda_ms(torch, lambda Z=Z, N=N, m=m: FT.colsum_ordered_plain(Z, N, m), 3)
            r.lib_ms = cuda_ms(torch, lambda Z=Z, N=N, m=m: Z[:m, :N].sum(0), 20)
            r.bound_ms, r.bound_by = bound(float(m * N), 4 * (m * N + N), PEAK_F32_FLOPS)
        cols.append(r)
    return emb, cols


def record_trunk_calls(fn):
    """Run fn() once with the fused trunk's wrappers recording their calls
    in launch order: ("fwd", m, last, keep, dtype) (fused_fine.trunk_fwd:
    last "sdf" for K1's column, z's n_store, or None; keep: the activation
    rows stored; dtype the trunk's, "bf16" or "f32"), ("uc", m, with_u,
    keep, dtype) (fused_fine.trunk_uchain), the backward's ("ut", m, keep,
    None, dtype) and ("dz", m, keep, None, dtype) (fused_fine.trunk_ut,
    trunk_dz; keep: the dm or dz rows stored), an f32 pass's
    its weight gradients' ("dw", m, color, None, "f32") (fused_fine.trunk_dw;
    color: K3's color rows join the launch), and the f32 color net's
    ("cfwd", m, keep, None, "f32") and ("cbwd", m, dz, None, "f32")
    (fused_fine_full.color_fwd_f32, color_bwd_f32; keep: the relu rows
    stored; dz: the dz rows stored, weight gradients asked), and the bf16
    color net's ("cfwd16", m, keep, None, "bf16") and ("cbwd16", m, dz,
    None, "bf16") (fused_fine_full.color_fwd, color_bwd)."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF

    calls = []
    fwd, uc, ut, dz, dw = FT.trunk_fwd, FT.trunk_uchain, FT.trunk_ut, FT.trunk_dz, FT.trunk_dw
    cfwd, cbwd = FF.color_fwd_f32, FF.color_bwd_f32
    cfwd16, cbwd16 = FF.color_fwd, FF.color_bwd

    def rec_fwd(e, m, ws, bs, tm, ss=None, acts=None, z=None, sdf=None, stream=None):
        last = "sdf" if sdf is not None else (None if z is None else z.shape[1])
        calls.append(("fwd", m, last, acts is not None, tm.dtype))
        return fwd(e, m, ws, bs, tm, ss=ss, acts=acts, z=z, sdf=sdf, stream=stream)

    def rec_uc(m, ws, wts, tm, ss, u=None, ts=None, cs=None, stream=None):
        calls.append(("uc", m, u is not None, ts is not None, tm.dtype))
        return uc(m, ws, wts, tm, ss, u=u, ts=ts, cs=cs, stream=stream)

    def rec_ut(m, ws, tm, du_b, du_s, ss, cs, c_last, ds, dms=None, stream=None):
        calls.append(("ut", m, dms is not None, None, tm.dtype))
        return ut(m, ws, tm, du_b, du_s, ss, cs, c_last, ds, dms, stream)

    def rec_dz(m, ws, tm, top, ss, ds, de, dzs=None, stream=None, wts=None, dzbs=None):
        calls.append(("dz", m, dzs is not None, None, tm.dtype))
        return dz(m, ws, tm, top, ss, ds, de, dzs, stream, wts=wts, dzbs=dzbs)

    def rec_dw(m, tm, rows, dws, dbs, acc, stream=None, color=None):
        calls.append(("dw", m, color is not None, None, tm.dtype))
        return dw(m, tm, rows, dws, dbs, acc, stream, color)

    def rec_cfwd(e, cx2, m, cws, cbs, meta, packed, cacts=None, stream=None):
        calls.append(("cfwd", m, cacts is not None, None, meta.dtype))
        return cfwd(e, cx2, m, cws, cbs, meta, packed, cacts, stream)

    def rec_cbwd(m, cws, meta, packed, dcolor, cacts, dx, cdz=None, stream=None):
        calls.append(("cbwd", m, cdz is not None, None, meta.dtype))
        return cbwd(m, cws, meta, packed, dcolor, cacts, dx, cdz, stream)

    def rec_cfwd16(e, cx2, m, cws, cbs, meta, packed, cacts=None, stream=None):
        calls.append(("cfwd16", m, cacts is not None, None, meta.dtype))
        return cfwd16(e, cx2, m, cws, cbs, meta, packed, cacts, stream)

    def rec_cbwd16(m, cws, cwts, meta, packed, dcolor, cacts, dx, cdz=None, cdzb=None,
                   stream=None):
        calls.append(("cbwd16", m, cdz is not None, None, meta.dtype))
        return cbwd16(m, cws, cwts, meta, packed, dcolor, cacts, dx, cdz, cdzb, stream)

    FT.trunk_fwd, FT.trunk_uchain, FT.trunk_ut, FT.trunk_dz, FT.trunk_dw = (
        rec_fwd, rec_uc, rec_ut, rec_dz, rec_dw)
    FF.color_fwd_f32, FF.color_bwd_f32 = rec_cfwd, rec_cbwd
    FF.color_fwd, FF.color_bwd = rec_cfwd16, rec_cbwd16
    try:
        fn()
    finally:
        FT.trunk_fwd, FT.trunk_uchain, FT.trunk_ut, FT.trunk_dz, FT.trunk_dw = fwd, uc, ut, dz, dw
        FF.color_fwd_f32, FF.color_bwd_f32 = cfwd, cbwd
        FF.color_fwd, FF.color_bwd = cfwd16, cbwd16
    return calls


def ragged_trunk_calls():
    """The fused trunk at sizes the main path's (multiples of a tile, or the
    step's 56,448) leave out: one point, a consumer's half less one, a
    half, a half and one, 1,001 and 65,613 points, each output mode."""
    return [c + ("bf16",) for m in (1, 63, 64, 65, 1001, 65613)
            for c in (("fwd", m, 320, False), ("fwd", m, 257, True), ("fwd", m, None, True),
                      ("fwd", m, "sdf", False), ("uc", m, True, False), ("uc", m, True, True),
                      ("uc", m, False, True))]


def trunk_nets(torch, dev, fs=None):
    """The flagship's trunk as the fused kernels' callers pack it (the fine
    pass's pack_fine_color, d_out 257, Op 320; K1's FusedHandSDF, the sdf
    column), its config, and perpoint_pose's pose and 262,144 points."""
    from honerf_torch.models.fields import pack_fine_color
    from honerf_torch.ops import fused_hand as FH

    fs = fs or flagship(torch, dev)
    pose, pts = perpoint_pose(torch, dev, 1 << 18)
    return SimpleNamespace(fine=pack_fine_color(fs.params, fs.sdf, fs.color),
                           k1=FH.FusedHandSDF(fs.params["sdf"], fs.sdf), cfg=fs.sdf, pose=pose,
                           pts=pts)


def trunk_readings(torch, dev, nets, calls, timed: bool = True):
    """hand_trunk_fwd_kernel ("fwd") and hand_uchain_kernel ("uc") alone at
    `calls` (record_trunk_calls' tuples), each distinct call once, weighted
    by its count, on the flagship's weights (trunk_nets; K1's for the sdf
    column) and the embedding of the call's first m points
    (hand_embed_kernel, bf16).  The u-chain's sigmoid rows come from the
    plain forward.  Every output the call asks for, into NaN-filled
    buffers, against the plain version on the card (trunk_fwd_plain,
    trunk_uchain_plain; the t rows rounded to bf16 as the kernel stores
    them) under the kernel rule (TOL_MEDIAN, TOL_MAX of each output's
    range), and a second run's bits.  The sigmoid rows s = sigmoid(100 z)
    are held at the median alone: their slope, up to 25, turns the bf16
    flip of an input activation that the rule's max allows into ~25x that
    in s.  Their max is held through what reads them: the u-chain kernel
    run on the kernel's rows against the plain u-chain on the plain rows
    (u under the kernel rule).  timed: ms of the kernel and of its
    plain version, and its bound (each input read once, each output
    written once; the products of the unpadded layers)."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_hand as FH

    stream = torch.cuda.current_stream(dev).cuda_stream
    nan, bf16, f32 = float("nan"), torch.bfloat16, torch.float32
    cfg, out = nets.cfg, []
    for (kind, m, a, keep, dtype), count in _tally(calls).items():
        assert dtype == "bf16", "trunk_readings takes the bf16 trunk's calls"
        k1 = a == "sdf"
        ws, bs, tm = ((nets.k1.ws, nets.k1.bs, nets.k1.meta.trunk) if k1 else
                      (nets.fine.ws, nets.fine.bs, nets.fine.meta.trunk_meta))
        n, Hp, Ep = tm.n_layers, tm.Hp, tm.Ep
        e = torch.empty((m, Ep), device=dev, dtype=bf16)
        FH.embed(FH._lib("fused_hand"), nets.pts, m, *nets.pose, cfg.v_multires,
                 cfg.r_multires, e, stream)
        rows = lambda dt: [torch.full((m, Hp), nan, device=dev, dtype=dt)  # noqa: E731
                           for _ in range(n - 1)]
        if kind == "fwd":
            def outs():
                return dict(ss=None if k1 else torch.full((n - 1, m, Hp), nan, device=dev),
                            acts=rows(bf16) if keep else None,
                            z=torch.full((m, a), nan, device=dev) if type(a) is int else None,
                            sdf=torch.full((m,), nan, device=dev) if k1 else None)

            def run(o):
                FT.trunk_fwd(e, m, ws, bs, tm, stream=stream, **o)

            def plain():
                return FT.trunk_fwd_plain(e, m, ws, bs, tm, last=a is not None)

            o1, o2 = outs(), outs()
            run(o1)
            run(o2)
            p_acts, p_ss, p_z = plain()
            pairs = [("sdf", o1["sdf"], p_z[:, 0])] if k1 else []
            if type(a) is int:
                pairs.append(("z", o1["z"], p_z[:, :a]))
            if not k1:
                pairs += [(f"ss[{l}] (median)", o1["ss"][l], p_ss[l]) for l in range(n - 1)]
                u_k = torch.full((m, Ep), nan, device=dev)
                FT.trunk_uchain(m, ws, nets.fine.wts, tm, o1["ss"], u=u_k, stream=stream)
                pairs.append(("u from the kernel's s", u_k,
                              FT.trunk_uchain_plain(p_ss, ws, tm)[0]))
            if keep:
                pairs += [(f"acts[{l}]", o1["acts"][l], p_acts[l]) for l in range(n - 1)]
            d = 1 if k1 else (min(a, cfg.d_out) if a is not None else 0)
            dims = trunk_dims(cfg, max(d, 1))[:None if d else -1]
            flops = 2.0 * m * sum(i * o for i, o in dims)
            n_bytes = (nbytes([e, *ws, *bs]) + (0 if k1 else (n - 1) * m * Hp * 4)
                       + (keep and (n - 1) * m * Hp * 2) + (4 * m * d if d else 0))
        else:
            _, p_ss0, _ = FT.trunk_fwd_plain(e, m, ws, bs, tm, last=False)
            ss = torch.stack(p_ss0)
            del p_ss0

            def outs():
                return dict(u=torch.full((m, Ep), nan, device=dev) if a else None,
                            ts=rows(bf16) if keep else None,
                            cs=[None] + rows(f32)[1:] if keep else None)

            def run(o):
                FT.trunk_uchain(m, ws, nets.fine.wts, tm, ss, stream=stream, **o)

            def plain():
                return FT.trunk_uchain_plain(list(ss), ws, tm, with_u=a)

            o1, o2 = outs(), outs()
            run(o1)
            run(o2)
            p_u, p_ts, p_cs = plain()
            pairs = [("u", o1["u"], p_u)] if a else []
            if keep:
                pairs += [(f"ts[{l}]", o1["ts"][l], p_ts[l].to(bf16)) for l in range(n - 1)]
                pairs += [(f"cs[{l}]", o1["cs"][l], p_cs[l]) for l in range(1, n - 1)]
            H, E = cfg.d_hidden, cfg.input_width
            flops = 2.0 * m * (H * H * (n - 2) + (2 * H * E if a else 0)) + m * H
            n_bytes = (nbytes([ss, *ws[:n - 1]]) + 2 * Hp + (4 * m * Ep if a else 0)
                       + (keep and (n - 1) * m * Hp * 2 + (n - 2) * m * Hp * 4))
        torch.cuda.synchronize()
        checks = [compare(torch, what, got, want, TOL_MEDIAN,
                          float("inf") if what.endswith("(median)") else TOL_MAX)
                  for what, got, want in pairs]
        worst = max(float((got.float() - want.float()).abs().max())
                    / max(float(want.abs().max()), 1e-6) for what, got, want in pairs
                    if not what.endswith("(median)"))
        same = all(torch.equal(x, y) for k in o1 if o1[k] is not None
                   for x, y in zip(o1[k] if isinstance(o1[k], list) else [o1[k]],
                                   o2[k] if isinstance(o2[k], list) else [o2[k]])
                   if x is not None)
        r = SimpleNamespace(kind=kind, m=m, a=a, keep=keep, count=count, checks=checks,
                            ok=all(c[0] for c in checks) and same, same=same, worst=worst,
                            max_abs=max(c[1] for c in checks), ms=None, plain_ms=None,
                            bound_ms=None, bound_by=None)
        if timed:
            r.ms = cuda_ms(torch, lambda: run(o1), 10)
            r.plain_ms = cuda_ms(torch, plain, 2)
            r.bound_ms, r.bound_by = bound(flops, n_bytes)
        del o1, o2, pairs, e
        out.append(r)
    return out


def trunk_text(r) -> str:
    """One reading of trunk_readings as a log line."""
    what = (f"{r.kind} m {r.m} " + (f"last {r.a}" if r.kind == "fwd" else f"u {r.a}")
            + f" keep {r.keep}" + (f" x{r.count}" if r.count > 1 else ""))
    worst = max(r.checks, key=lambda c: c[1])[2]
    text = (f"{what}: {len(r.checks)} outputs within the kernel rule: "
            f"{all(c[0] for c in r.checks)} (the worst: {worst}); a rerun's bits {r.same}")
    if r.ms is not None:
        text += (f"; kernel {r.ms:.4f} ms, plain {r.plain_ms:.3f} ms, bound {r.bound_ms:.4f} ms "
                 f"({r.bound_by}): {r.bound_ms / r.ms:.2f} of it")
    return text + ("" if r.ok else " FAIL")


# The f32 trunk's pairs of launches at the calls the f32 paths make: one
# '12' fit step, one f32 'full' and 'pallas' step and one f32 request
# (record_trunk_calls, filled by the f32 and fit phases)
TRUNK32_CALLS = {}
# the bf16 color net's calls of a request and each bf16 step mode
# (record_trunk_calls, filled by the fused trunk phase)
COLOR16_CALLS = {}
# The f32 backward's calls (trunk_ut, trunk_dz) of one f32 'full',
# 'full_nocolor' and 'pallas' step and one '12' fit step (the same
# recordings; the 'full_nocolor' step's only here)
TRUNK_BWD32_CALLS = {}
# The bf16 backward pair's calls (trunk_ut, trunk_dz) of a request and of
# one bf16 'full', 'full_nocolor' and 'pallas' step (record_trunk_calls,
# filled by the fused trunk phase)
TRUNK_BWD16_CALLS = {}
# their launches a step or request (gemm_f32_kernel, uchain_seed_kernel,
# hand_trunk_fwd_f32_kernel, hand_uchain_f32_kernel, hand_trunk_ut_f32_kernel,
# hand_trunk_dz_f32_kernel, trunk_dw_f32_kernel, gemm_tn_f32_kernel,
# colsum_partial_kernel, color_fwd_f32_kernel, color_bwd_f32_kernel,
# color_dz_kernel), filled beside them
TRUNK32_COUNTS = {}
TRUNK32_KERNELS = ("GEMM_F32", "UCHAIN", "TFWD32", "TUCH32", "TUT32", "TDZ32", "TDW32",
                   "GEMM_TN_F32", "COLSUM", "CFWD32", "CBWD32", "COLOR_DZ")
# The fused f32 pair against the split launches, both against f64 in L2:
# no worse than the split's worst output, by this factor (the same split,
# the same 32-deep fresh sums; wgmma's internal order is not mma.sync's)
TOL_TRUNK32_VS_SPLIT = 1.25
# The f32 paths' launches a step or request (TRUNK32_KERNELS): no
# gemm_f32_kernel (the color net's 5 a pass of K2, of K3's recompute and of
# its backward before its two fused kernels), no seed, the fused forward
# pair once a pass of K2, K3, K5 and K6, the fused backward pair once a pass
# of K3 and K6 (the trunk backward's 17 gemm_f32_kernel a pass before it),
# the weight gradients' one launch a pass of K3 and K6 with dW (the color
# net's joining K3's) and no TN GEMM or column sum (20-26 and 9-14 a pass
# before it), the color net's forward once a pass of K2 and of K3's
# recompute, its transpose once a pass of K3, no color_dz_kernel; a fit
# step's nets are frozen
TRUNK32_LAUNCHES = {"f32 'full' step": (0, 0, 4, 4, 2, 2, 2, 0, 0, 4, 2, 0),
                    "'12' fit step": (0, 0, 4, 4, 2, 2, 0, 0, 0, 4, 2, 0),
                    "f32 'pallas' step": (0, 0, 4, 4, 2, 2, 2, 0, 0, 0, 0, 0),
                    "f32 request": (0, 0, 16, 16, 0, 0, 0, 0, 0, 16, 0, 0)}


def trunk32_pairs(calls):
    """The recorded f32 calls (record_trunk_calls) as (forward, u-chain)
    pairs: (m, last, keep, with_u), each forward followed by its u-chain."""
    f32 = [c for c in calls if c[-1] == "f32" and c[0] in ("fwd", "uc")]
    pairs = []
    for fwd, uc in zip(f32[::2], f32[1::2]):
        assert fwd[0] == "fwd" and uc[0] == "uc" and fwd[1] == uc[1] and fwd[3] == uc[3], \
            f"an f32 forward not followed by its u-chain: {fwd}, {uc}"
        pairs.append((fwd[1], fwd[2], fwd[3], uc[2]))
    return pairs


def ragged_trunk32_pairs():
    """The f32 pair at sizes the main path's leave out, each output mode:
    K2's / K5's (z, u), K3's recompute (z 320, u, keep), K6's (keep only)."""
    return [(m, a, keep, u) for m in (1, 63, 64, 65, 1001, 65613)
            for a, keep, u in ((257, False, True), (320, True, True), (None, True, False))]


def trunk_f64(torch, e, m, ws, bs, tm, last: bool, with_u: bool):
    """The f32 trunk's forward and u-chain in f64 on the same f32 values
    (trunk_fwd_plain's and trunk_uchain_plain's statements): (acts, ss, z,
    u, ts, cs)."""
    import math

    n, Hp, skip = tm.n_layers, tm.Hp, tm.skip
    inv = 1.0 / math.sqrt(2.0)
    x0 = e[:m].double()
    W, B = [w.double() for w in ws], [b.double() for b in bs]
    a, acts, ss, z = x0, [], [], None
    for l in range(n if last else n - 1):
        x = torch.cat([a, x0], dim=1) * inv if l == skip else a
        y = x @ W[l] + B[l]
        if l < n - 1:
            ss.append(torch.sigmoid(100.0 * y))
            a = torch.logaddexp(100.0 * y, torch.zeros_like(y)) / 100.0
            acts.append(a)
        else:
            z = y
    ts, cs = [None] * n, [None] * n
    t = ts[n - 2] = W[n - 1][:Hp, 0] * ss[n - 2]
    u = None
    for l in range(n - 2, -1 if with_u else 0, -1):
        mm = t @ W[l].T
        if l == skip:
            c, u = mm[:, :Hp] * inv, mm[:, Hp:] * inv
        else:
            c = mm
        cs[l] = c
        if l > 0:
            t = ts[l - 1] = c * ss[l - 1]
        else:
            u = u + c
    return acts, ss, z, u, ts, cs


def trunk32_readings(torch, dev, nets, pairs, timed: bool = True):
    """hand_trunk_fwd_f32_kernel then hand_uchain_f32_kernel at each
    distinct (m, last, keep, with_u) of `pairs` (trunk32_pairs), weighted
    by its count, on the flagship's f32 trunk (nets: pack_fine_color in
    f32) and the f32 embedding of the call's first m points: every output
    the call asks for (z, each sigmoid row, u; with keep each activation,
    t and c row), into NaN-filled buffers, against the plain versions on
    the card under the f32 kernel rule (TOL_F32 of each output's range at
    the median and the max), a second run's bits, and the relative L2 of
    each output to its f64 value (trunk_f64) beside the split launches'
    (fused_fine.cuda_trunk_forward_split: one gemm_f32_kernel a layer and
    uchain_seed_kernel) at the same call, the pair's worst within
    TOL_TRUNK32_VS_SPLIT of the split's worst.  timed: ms of each kernel,
    of the split launches and of the plain versions, and the pair's bound
    (3xTF32 operations of the unpadded layers; each input read once, each
    output written once)."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF
    from honerf_torch.ops import fused_hand as FH

    stream = torch.cuda.current_stream(dev).cuda_stream
    nan, f32 = float("nan"), torch.float32
    tm, cfg = nets.fine32.meta.trunk_meta, nets.cfg
    ws, bs, wts = nets.fine32.ws, nets.fine32.bs, nets.fine32.wts
    n, Hp, Ep = tm.n_layers, tm.Hp, tm.Ep
    lib = FF._lib()
    out = []
    for (m, a, keep, with_u), count in _tally(pairs).items():
        e = torch.empty((m, Ep), device=dev, dtype=f32)
        FH.embed(FH._lib("fused_hand"), nets.pts, m, *nets.pose, cfg.v_multires,
                 cfg.r_multires, e, stream)
        rows = lambda: [torch.full((m, Hp), nan, device=dev) for _ in range(n - 1)]  # noqa

        def outs():
            return dict(ss=torch.full((n - 1, m, Hp), nan, device=dev),
                        acts=rows() if keep else None,
                        z=torch.full((m, a), nan, device=dev) if a else None,
                        u=torch.full((m, Ep), nan, device=dev) if with_u else None,
                        ts=rows() if keep else None,
                        cs=[None] + rows()[1:] if keep else None)

        def fwd(o):
            FT.trunk_fwd(e, m, ws, bs, tm, ss=o["ss"], acts=o["acts"], z=o["z"], stream=stream)

        def uc(o):
            FT.trunk_uchain(m, ws, wts, tm, o["ss"], u=o["u"], ts=o["ts"], cs=o["cs"],
                            stream=stream)

        def split(o):
            buf = dict(ss=o["ss"], acts=o["acts"] or [], ts=o["ts"] or [], cs=o["cs"])
            FT.cuda_trunk_forward_split(lib, e, m, ws, bs, wts, tm, buf, stream, keep=keep,
                                        z=o["z"], u=o["u"])

        def plain_fwd():
            return FT.trunk_fwd_plain(e, m, ws, bs, tm, last=a is not None)

        def plain_uc(p_ss):
            return FT.trunk_uchain_plain(p_ss, ws, tm, with_u=with_u)

        def plain():
            p_acts, p_ss, p_z = plain_fwd()
            return (p_acts, p_ss, p_z) + plain_uc(p_ss)

        o1, o2, sp = outs(), outs(), outs()
        for o in (o1, o2):
            fwd(o)
            uc(o)
        split(sp)
        want = plain()
        ref = trunk_f64(torch, e, m, ws, bs, tm, a is not None, with_u)
        torch.cuda.synchronize()

        def named(o):
            """(name, tensor) of every output the call asks for; o a
            kernel's buffers (dict) or (acts, ss, z, u, ts, cs)."""
            if isinstance(o, dict):
                acts_, ss_, z_, u_, ts_, cs_ = (o["acts"], list(o["ss"]), o["z"], o["u"],
                                                o["ts"], o["cs"])
            else:
                acts_, ss_, z_, u_, ts_, cs_ = o
                z_ = z_[:, :a] if a else None
            items = [("z", z_)] if a else []
            items += [(f"ss[{l}]", ss_[l]) for l in range(n - 1)]
            items += [("u", u_[:, :Ep])] if with_u else []
            if keep:
                items += [(f"acts[{l}]", acts_[l]) for l in range(n - 1)]
                items += [(f"ts[{l}]", ts_[l]) for l in range(n - 1)]
                items += [(f"cs[{l}]", cs_[l]) for l in range(1, n - 1)]
            return items

        k_items, p_items = named(o1), named(want)
        s_items, r_items = named(sp), named(ref)
        checks = [compare(torch, what, got, w, TOL_F32, TOL_F32)
                  for (what, got), (_, w) in zip(k_items, p_items)]
        # the rule's reading: the worst median or max over TOL_F32 of the range
        rule = max(max(rd[0], rd[2]) / (TOL_F32 * rd[3]) if rd[3] > 0 else 0.0
                   for rd in (err_readings(torch, got, w)
                              for (_, got), (_, w) in zip(k_items, p_items)))

        def l2(got, r):
            return float((got.double() - r).norm()) / max(float(r.norm()), 1e-300)

        k_l2 = [l2(g, r) for (_, g), (_, r) in zip(k_items, r_items)]
        s_l2 = [l2(g, r) for (_, g), (_, r) in zip(s_items, r_items)]
        same = all(torch.equal(x, y) for (_, x), (_, y) in zip(k_items, named(o2)))
        worst_k, worst_s = max(k_l2), max(s_l2)
        r = SimpleNamespace(m=m, a=a, keep=keep, with_u=with_u, count=count, checks=checks,
                            same=same, worst_k=worst_k, worst_s=worst_s, rule=rule,
                            l2_ratio=worst_k / (TOL_TRUNK32_VS_SPLIT * max(worst_s, 1e-30)),
                            worst_what=k_items[k_l2.index(worst_k)][0],
                            max_abs=max(c[1] for c in checks),
                            ok=all(c[0] for c in checks) and same
                            and worst_k <= TOL_TRUNK32_VS_SPLIT * worst_s,
                            fwd_ms=None, uc_ms=None, ms=None, split_ms=None, plain_ms=None,
                            fwd_plain_ms=None, uc_plain_ms=None, bound_ms=None, bound_by=None,
                            fwd_bound_ms=None, uc_bound_ms=None)
        if timed:
            d = min(a, cfg.d_out) if a else 0
            dims = trunk_dims(cfg, max(d, 1))[:None if d else -1]
            H, E = cfg.d_hidden, cfg.input_width
            f_flops = 2.0 * m * sum(i * o for i, o in dims)
            u_flops = 2.0 * m * (H * H * (n - 2) + (2 * H * E if with_u else 0)) + m * H
            w_bytes = nbytes([*ws, *bs])
            f_bytes = (4 * m * Ep + w_bytes + (n - 1) * m * Hp * 4 * (2 if keep else 1)
                       + 4 * m * d)
            u_bytes = ((n - 1) * m * Hp * 4 + nbytes(ws[:n - 1]) + 4 * Hp
                       + (4 * m * Ep if with_u else 0) + (keep and (2 * n - 3) * m * Hp * 4))
            r.fwd_ms = cuda_ms(torch, lambda: fwd(o1), 10)
            r.uc_ms = cuda_ms(torch, lambda: uc(o1), 10)
            r.ms = r.fwd_ms + r.uc_ms
            r.split_ms = cuda_ms(torch, lambda: split(sp), 5)
            r.fwd_plain_ms = cuda_ms(torch, plain_fwd, 2)
            p_ss = list(o1["ss"])
            r.uc_plain_ms = cuda_ms(torch, lambda: plain_uc(p_ss), 2)
            r.plain_ms = r.fwd_plain_ms + r.uc_plain_ms
            peak = PEAK_F32_3XTF32_FLOPS
            r.fwd_bound_ms, _ = bound(f_flops, f_bytes, peak)
            r.uc_bound_ms, _ = bound(u_flops, u_bytes, peak)
            r.bound_ms, r.bound_by = bound(f_flops + u_flops, f_bytes + u_bytes, peak)
        del o1, o2, sp, want, ref, e
        torch.cuda.empty_cache()
        out.append(r)
    return out


def trunk32_nets(torch, dev):
    """The flagship's trunk with the conf's own f32 trunks, as the fine
    pass packs it (pack_fine_color: d_out 257, Op 320), its config, and
    perpoint_pose's pose and 262,144 points."""
    from honerf_torch.models.fields import pack_fine_color

    fs = flagship(torch, dev, "f32")
    pose, pts = perpoint_pose(torch, dev, 1 << 18)
    return SimpleNamespace(fine32=pack_fine_color(fs.params, fs.sdf, fs.color), cfg=fs.sdf,
                           pose=pose, pts=pts)


def trunk32_text(r) -> str:
    """One reading of trunk32_readings as a log line."""
    what = (f"m {r.m} last {r.a} keep {r.keep} u {r.with_u}"
            + (f" x{r.count}" if r.count > 1 else ""))
    worst = max(r.checks, key=lambda c: c[1])[2]
    text = (f"{what}: {len(r.checks)} outputs within the f32 rule: "
            f"{all(c[0] for c in r.checks)} (the worst: {worst}); a rerun's bits {r.same}; "
            f"L2 vs f64 worst {r.worst_k:.2e} ({r.worst_what}), the split launches' "
            f"{r.worst_s:.2e} (tol {TOL_TRUNK32_VS_SPLIT:g}x)")
    if r.ms is not None:
        text += (f"; fwd {r.fwd_ms:.4f} ms (bound {r.fwd_bound_ms:.4f}), u-chain "
                 f"{r.uc_ms:.4f} ms (bound {r.uc_bound_ms:.4f}), the pair {r.ms:.4f} ms against "
                 f"the split launches' {r.split_ms:.4f} ms, plain {r.plain_ms:.3f} ms, bound "
                 f"{r.bound_ms:.4f} ms ({r.bound_by}): {r.bound_ms / r.ms:.2f} of it")
    return text + ("" if r.ok else " FAIL")


def trunk_bwd32_calls(calls):
    """The recorded f32 backward calls (record_trunk_calls) as (m, keep),
    each upward chain followed by its downward one."""
    bwd = [c for c in calls if c[0] in ("ut", "dz")]
    out = []
    for ut, dz in zip(bwd[::2], bwd[1::2]):
        assert ut[0] == "ut" and dz[0] == "dz" and ut[1:3] == dz[1:3], \
            f"an upward chain not followed by its downward one: {ut}, {dz}"
        out.append((ut[1], ut[2]))
    return out


def trunk_bwd16_inputs(torch, dev, nets, m):
    """The bf16 backward's inputs at m points on the flagship's bf16 trunk
    (trunk_nets' fine pack): the bf16 embedding of the first m points, the
    forward's rows (the plain versions on the card: f32 sigmoid and c rows;
    the activation and t rows in bf16; the kept rows and the c rows the
    planes of one tensor each, as trunk_buffers keeps them),
    seeded cotangents du (du_b = bf16(du), du_s = bf16(du / sqrt2)) and the
    top one (d_out live columns of Op, the rest 0; bf16, and its f32
    values), as the seed kernel writes them."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_hand as FH

    pack, cfg = nets.fine, nets.cfg
    tm, ws = pack.meta.trunk_meta, pack.ws
    n, bf16 = tm.n_layers, torch.bfloat16
    e = torch.empty((m, tm.Ep), device=dev, dtype=bf16)
    FH.embed(FH._lib("fused_hand"), nets.pts, m, *nets.pose, cfg.v_multires, cfg.r_multires, e,
             torch.cuda.current_stream(dev).cuda_stream)
    acts, ss, _ = FT.trunk_fwd_plain(e, m, ws, pack.bs, tm, last=False)
    _, ts, cs = FT.trunk_uchain_plain(ss, ws, tm)
    gen = torch.Generator(device=dev).manual_seed(m)
    du = torch.zeros((m, tm.Ep), device=dev)
    du[:, :tm.emb_width] = torch.randn((m, tm.emb_width), device=dev, generator=gen)
    top = torch.zeros((m, tm.Op), device=dev)
    top[:, :tm.d_out] = torch.randn((m, tm.d_out), device=dev, generator=gen)

    def planes(xs):
        return list(torch.stack([x.to(bf16) for x in xs]).unbind(0))

    return SimpleNamespace(e=e, acts=planes(acts[:n - 1]), ss=torch.stack(ss),
                           ts=planes(ts[:n - 1]),
                           cs=[None] + list(torch.stack(cs[1:n - 1]).unbind(0)),
                           c_last=ws[n - 1][:, 0].float().contiguous(), du_b=du.to(bf16),
                           du_s=(du * FT.INV_SQRT2).to(bf16), top=top.to(bf16))


def trunk_bwd16_readings(torch, dev, nets, calls, timed: bool = True, reruns: int = 8):
    """hand_trunk_ut_kernel then hand_trunk_dz_kernel at each distinct (m,
    keep) of `calls` (trunk_bwd32_calls of a bf16 path), weighted by its
    count, on the flagship's bf16 trunk at trunk_bwd16_inputs: each chain
    alone (trunk_ut; trunk_dz on the plain ds) into NaN-filled buffers
    against trunk_ut_plain / trunk_dz_plain on the card under the kernel
    rule (TOL_MEDIAN, TOL_MAX of each output's range; the median only past
    one point): ds, de, with keep the kept dm rows (the plain rows rounded
    to bf16) and dz rows (f32; the bf16 rows the f32 ones rounded); then
    through cuda_trunk_backward (the pair, then with keep the dW sequence
    on its kept rows) every output (ds, de; with keep the kept dm, dz and
    bf16 dz rows, each dW and db) against the bits of `reruns` more runs
    (a race between the kernels' warps shows as a rerun's moved bits) and
    the SHA-256 of cuda_trunk_backward_split's (one gemm_kernel a layer,
    the dW launches beside them) at the same call.  timed: ms of each kernel
    (the call's keep), of the pair and of the split chain (want_dw off:
    its 17 gemm_kernel) in turns (pair, split, split, pair), of the plain
    chains, and the bounds (bf16 operations of the unpadded layers; each
    input read once, each output written once)."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF

    stream = torch.cuda.current_stream(dev).cuda_stream
    nan, bf16 = float("nan"), torch.bfloat16
    pack, cfg = nets.fine, nets.cfg
    tm, ws, wts = pack.meta.trunk_meta, pack.ws, pack.wts
    n, Hp, Ep, Op = tm.n_layers, tm.Hp, tm.Ep, tm.Op
    lib = FF._bwd_lib()
    scratch = torch.empty((FT._WS_FLOATS,), device=dev)
    out = []
    for (m, keep), count in _tally(calls).items():
        x = trunk_bwd16_inputs(torch, dev, nets, m)
        buf = dict(ss=x.ss, acts=x.acts, ts=x.ts, cs=x.cs)

        def fresh(m=m, keep=keep, x=x):
            bw = FT.trunk_bwd_buffers(ws, tm, m, dev, Op, keep)
            for t in [bw["ds"], bw["de"]] + (bw["dms"][1:] + bw["dzs"] + bw["dzbs"]
                                             if keep else []):
                t.fill_(nan)
            bw["du_b"].copy_(x.du_b)
            bw["du_s"].copy_(x.du_s)
            bw["dzb"][0].copy_(x.top)
            bw["dzf"][0].copy_(x.top.float())
            dws = [torch.zeros(w.shape, device=dev) for w in ws] if keep else None
            dbs = [torch.zeros(b.shape, device=dev) for b in pack.bs] if keep else None
            return bw, dws, dbs

        def backward(o, fn, m=m, keep=keep, x=x, buf=buf):
            fn(lib, m, x.e, ws, wts, tm, buf, o[0], o[1], o[2], keep, 0, scratch, stream)

        def outs(o, m=m, keep=keep):
            bw, dws, dbs = o
            items = [("de", bw["de"][:m])] + [(f"ds[{l}]", bw["ds"][l][:m]) for l in range(n - 1)]
            if keep:
                items += ([(f"dm[{l}]", bw["dms"][l][:m]) for l in range(1, n)]
                          + [(f"dz[{l}]", bw["dzs"][l][:m]) for l in range(n - 1)]
                          + [(f"dzb[{l}]", bw["dzbs"][l][:m]) for l in range(n - 1)]
                          + [(f"dW[{l}]", w) for l, w in enumerate(dws)]
                          + [(f"db[{l}]", b) for l, b in enumerate(dbs)])
            return items

        def chains(o, ds, m=m, keep=keep, x=x):
            bw = o[0]
            FT.trunk_ut(m, ws, tm, x.du_b, x.du_s, x.ss, x.cs, x.c_last, bw["ds"],
                        bw["dms"] if keep else None, stream)
            FT.trunk_dz(m, ws, tm, x.top, x.ss, bw["ds"] if ds is None else ds, bw["de"],
                        bw["dzs"] if keep else None, stream, wts=wts,
                        dzbs=bw["dzbs"] if keep else None)

        ds_p, dms_p = FT.trunk_ut_plain(x.du_b, x.du_s, m, ws, x.ss, x.cs + [x.c_last], tm,
                                        keep=True)
        ds_plain = torch.stack(ds_p)
        de_p, dzs_p = FT.trunk_dz_plain(x.top, m, ws, x.ss, ds_plain, tm, keep=True)
        alone = fresh()
        chains(alone, ds_plain)
        o1, o2, sp = fresh(), fresh(), fresh()
        backward(o1, FT.cuda_trunk_backward)
        backward(sp, FT.cuda_trunk_backward_split)
        torch.cuda.synchronize()
        want = {"de": de_p, **{f"ds[{l}]": ds_p[l] for l in range(n - 1)}}
        if keep:
            want |= {f"dm[{l}]": dms_p[l].to(bf16).float() for l in range(1, n)}
            want |= {f"dz[{l}]": dzs_p[l] for l in range(n - 1)}
            want |= {f"dzb[{l}]": dzs_p[l].to(bf16).float() for l in range(n - 1)}
        med = TOL_MEDIAN if m > 1 else 1.0
        pairs = [(k, g.float(), want[k]) for k, g in outs(alone) if k in want]
        checks = [compare(torch, k, g, w, med) for k, g, w in pairs]
        rule = max(max(rd[0] / med, rd[2] / TOL_MAX) / rd[3]
                   for rd in (err_readings(torch, g, w) for _, g, w in pairs))
        got = outs(o1)
        finite = all(bool(torch.isfinite(g.float()).all()) for _, g in got)
        n_same = 0
        for _ in range(reruns):
            backward(o2, FT.cuda_trunk_backward)
            n_same += all(torch.equal(a, b) for (_, a), (_, b) in zip(got, outs(o2)))
        same = n_same == reruns
        moved = [k for (k, a), (_, b) in zip(got, outs(sp)) if sha256(torch, a) != sha256(torch, b)]
        r = SimpleNamespace(m=m, keep=keep, count=count, checks=checks, same=same, rule=rule,
                            n_same=n_same, reruns=reruns, moved=moved, n_outputs=len(got),
                            max_abs=max(c[1] for c in checks),
                            ok=all(c[0] for c in checks) and finite and same and not moved,
                            ut_ms=None, dz_ms=None, ms=None, split_ms=None, plain_ms=None,
                            ut_plain_ms=None, dz_plain_ms=None, bound_ms=None, bound_by=None,
                            ut_bound_ms=None, dz_bound_ms=None, ut_bound_by=None,
                            dz_bound_by=None)
        if timed:
            dims = trunk_dims(cfg, cfg.d_out)
            ut_flops = 2.0 * m * sum(i * o for i, o in dims[:-1])
            dz_flops = 2.0 * m * sum(i * o for i, o in dims)
            row = 4 * m * Hp
            kept_dm = keep and (n - 1) * 2 * m * Hp
            kept_dz = keep and (n - 1) * 6 * m * Hp
            ut_bytes = (2 * 2 * m * Ep + nbytes(ws[:n - 1]) + 4 * Hp + (n - 1) * row
                        + (n - 2) * row + (n - 1) * row + kept_dm)
            dz_bytes = 2 * m * Op + nbytes(ws) + 2 * (n - 1) * row + 4 * m * Ep + kept_dz
            o = o1
            bw = o[0]
            dms, dzs, dzbs = (bw["dms"], bw["dzs"], bw["dzbs"]) if keep else (None,) * 3
            r.ut_ms = cuda_ms(torch, lambda: FT.trunk_ut(
                m, ws, tm, bw["du_b"], bw["du_s"], x.ss, x.cs, bw["c_last"], bw["ds"], dms,
                stream), 10)
            r.dz_ms = cuda_ms(torch, lambda: FT.trunk_dz(
                m, ws, tm, bw["dzb"][0], x.ss, bw["ds"], bw["de"], dzs, stream, wts=wts,
                dzbs=dzbs), 10)
            chain = fresh(keep=False)
            pair_ms, split_ms = [], []
            for fn, into in ((lambda: chains(o, None), pair_ms),
                             (lambda: backward(chain, FT.cuda_trunk_backward_split, keep=False),
                              split_ms),
                             (lambda: backward(chain, FT.cuda_trunk_backward_split, keep=False),
                              split_ms),
                             (lambda: chains(o, None), pair_ms)):
                into.append(cuda_ms(torch, fn, 5))
            r.ms, r.split_ms = sum(pair_ms) / 2, sum(split_ms) / 2
            r.ut_plain_ms = cuda_ms(torch, lambda: FT.trunk_ut_plain(
                x.du_b, x.du_s, m, ws, x.ss, x.cs + [x.c_last], tm, keep=keep), 2)
            r.dz_plain_ms = cuda_ms(torch, lambda: FT.trunk_dz_plain(
                x.top, m, ws, x.ss, ds_plain, tm, keep=keep), 2)
            r.plain_ms = r.ut_plain_ms + r.dz_plain_ms
            r.ut_bound_ms, r.ut_bound_by = bound(ut_flops, ut_bytes)
            r.dz_bound_ms, r.dz_bound_by = bound(dz_flops, dz_bytes)
            r.bound_ms, r.bound_by = bound(ut_flops + dz_flops, ut_bytes + dz_bytes)
            del chain
        del o1, o2, sp, alone, x, buf, pairs, got
        torch.cuda.empty_cache()
        out.append(r)
    return out


def trunk_bwd16_text(r) -> str:
    """One reading of trunk_bwd16_readings as a log line."""
    what = f"m {r.m} keep {r.keep}" + (f" x{r.count}" if r.count > 1 else "")
    worst = max(r.checks, key=lambda c: c[1])[2]
    text = (f"{what}: {len(r.checks)} chain outputs within the kernel rule: "
            f"{all(c[0] for c in r.checks)} (the worst: {worst}); {r.n_outputs} outputs through "
            f"cuda_trunk_backward: the same bits on {r.n_same} of {r.reruns} reruns, the split "
            f"launches' SHA-256 "
            f"{'kept' if not r.moved else 'moved: ' + ', '.join(r.moved)}")
    if r.ms is not None:
        text += (f"; ut {r.ut_ms:.4f} ms (bound {r.ut_bound_ms:.4f}), dz {r.dz_ms:.4f} ms "
                 f"(bound {r.dz_bound_ms:.4f}), the pair {r.ms:.4f} ms against the split "
                 f"chain's {r.split_ms:.4f} ms ({r.ms / r.split_ms:.2f} of it), plain "
                 f"{r.plain_ms:.3f} ms, bound {r.bound_ms:.4f} ms ({r.bound_by}): "
                 f"{r.bound_ms / r.ms:.2f} of it")
    return text + ("" if r.ok else " FAIL")


def ragged_trunk_bwd32_calls():
    """The f32 backward at sizes the main path's leave out, with and
    without the kept rows (dW)."""
    return [(m, keep) for m in (1, 63, 64, 65, 1001, 65613) for keep in (False, True)]


def trunk_bwd_f64(torch, x, ws, tm, want_dw: bool):
    """The f32 trunk's backward in f64 on the same f32 values
    (_trunk_bwd_block's statements): ds, de and with want_dw every dW and
    db; x: trunk_bwd32_inputs' namespace."""
    import math

    n, Hp, skip = tm.n_layers, tm.Hp, tm.skip
    inv = 1.0 / math.sqrt(2.0)
    W = [w.double() for w in ws]
    S = [s.double() for s in x.ss]
    C = [None] + [c.double() for c in x.cs[1:n - 1]] + [x.c_last.double()]
    du = x.du.double()
    dm, dms, ds = du, [du], []
    for l in range(n - 1):
        xx = torch.cat([dm, du * inv], 1) if l == skip else dm
        dt = xx @ W[l]
        ds.append(dt * C[l + 1])
        dm = dt * S[l] * (inv if l + 1 == skip else 1.0)
        dms.append(torch.cat([dm, du * inv], 1) if l + 1 == skip else dm)
    dz = x.top.double()
    dzs, de = [None] * (n - 1) + [dz], None
    for l in range(n - 1, 0, -1):
        din = dz @ W[l].T
        if l == skip:
            da, de = din[:, :Hp] * inv, din[:, Hp:] * inv
        else:
            da = din
        dz = dzs[l - 1] = da * S[l - 1] + ds[l - 1] * (100.0 * S[l - 1] * (1.0 - S[l - 1]))
    out = dict(ds=ds, de=de + dz @ W[0].T)
    if want_dw:
        e = x.e.double()
        T = [t.double() for t in x.ts[:n - 1]] + [x.onehot.double()]
        ins = [e] + [torch.cat([a.double(), e], 1) * inv if l == skip else a.double()
                     for l, a in zip(range(1, n), x.acts)]
        out["dws"] = [dms[l].T @ T[l] + ins[l].T @ dzs[l] for l in range(n)]
        out["dbs"] = [dzs[l].sum(0) for l in range(n)]
    return out


def trunk_bwd32_inputs(torch, dev, nets, m):
    """The f32 backward's inputs at m points on the flagship's f32 trunk: the
    f32 embedding of the first m points, the forward's rows (the plain
    versions on the card: sigmoid, activation, t and c rows), seeded
    cotangents du (du_b; du_s = du / sqrt2) and the top one (d_out live
    columns of Op, the rest 0, as the seeds write it)."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_hand as FH

    tm, cfg, ws = nets.fine32.meta.trunk_meta, nets.cfg, nets.fine32.ws
    n, f32 = tm.n_layers, torch.float32
    e = torch.empty((m, tm.Ep), device=dev, dtype=f32)
    FH.embed(FH._lib("fused_hand"), nets.pts, m, *nets.pose, cfg.v_multires, cfg.r_multires, e,
             torch.cuda.current_stream(dev).cuda_stream)
    acts, ss, _ = FT.trunk_fwd_plain(e, m, ws, nets.fine32.bs, tm, last=False)
    _, ts, cs = FT.trunk_uchain_plain(ss, ws, tm)
    gen = torch.Generator(device=dev).manual_seed(m)
    du = torch.zeros((m, tm.Ep), device=dev)
    du[:, :tm.emb_width] = torch.randn((m, tm.emb_width), device=dev, generator=gen)
    top = torch.zeros((m, tm.Op), device=dev)
    top[:, :tm.d_out] = torch.randn((m, tm.d_out), device=dev, generator=gen)
    onehot = torch.zeros((m, tm.Op), device=dev)
    onehot[:, 0] = 1.0
    # the kept activation and t rows as the planes of one tensor each, as
    # trunk_buffers keeps them (the dW launch reads each as one map)
    acts = list(torch.stack(acts[:n - 1]).unbind(0))
    ts = list(torch.stack(ts[:n - 1]).unbind(0))
    return SimpleNamespace(e=e, acts=acts, ss=torch.stack(ss), ts=ts, cs=[None] + cs[1:n - 1],
                           c_last=ws[n - 1][:, 0].contiguous(), du=du,
                           du_s=du * FT.INV_SQRT2, top=top, onehot=onehot)


def trunk_bwd32_readings(torch, dev, nets, calls, timed: bool = True):
    """hand_trunk_ut_f32_kernel then hand_trunk_dz_f32_kernel at each
    distinct (m, keep) of `calls` (trunk_bwd32_calls), weighted by its
    count, on the flagship's f32 trunk (trunk32_nets) at
    trunk_bwd32_inputs: through cuda_trunk_backward (the two chains, then
    with keep the weight gradients' launch on their kept rows) every
    output (ds, de; with keep every kept dm and dz row, each dW and db),
    into NaN-filled buffers, against the plain versions on the card
    (trunk_ut_plain, trunk_dz_plain on the plain rows, dW_l = dm_l^T t_l +
    in_l^T dz_l and db_l in f32) under the f32 rule (TOL_F32 of each
    output's range at the median and the max), a second run's bits, and
    the relative L2 of ds, de (and each dW, db) to f64 (trunk_bwd_f64)
    beside the split launches' (cuda_trunk_backward_split: one
    gemm_f32_kernel a layer) at the same call, the fused worst within
    TOL_TRUNK32_VS_SPLIT of the split's worst.  timed: ms of each kernel
    (the call's keep), of the fused chain, of the split chain (want_dw
    off: its 17 launches) and of the plain chains, and the bounds (3xTF32
    operations of the unpadded layers; each input read once, each output
    written once)."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF

    stream = torch.cuda.current_stream(dev).cuda_stream
    nan = float("nan")
    tm, cfg = nets.fine32.meta.trunk_meta, nets.cfg
    ws, wts = nets.fine32.ws, nets.fine32.wts
    n, Hp, Ep, Op = tm.n_layers, tm.Hp, tm.Ep, tm.Op
    lib = FF._bwd_lib()
    scratch = torch.empty((FT._WS_FLOATS,), device=dev)
    out = []
    for (m, keep), count in _tally(calls).items():
        x = trunk_bwd32_inputs(torch, dev, nets, m)
        buf = dict(ss=x.ss, acts=x.acts, ts=x.ts, cs=x.cs)

        def fresh(m=m, keep=keep, x=x):
            bw = FT.trunk_bwd_buffers(ws, tm, m, dev, Op, keep)
            for k in ("ds", "de"):
                bw[k].fill_(nan)
            for t in (bw.get("dms") or [])[1:] + (bw.get("dzs") or []):
                t.fill_(nan)
            bw["du_b"].copy_(x.du)
            bw["du_s"].copy_(x.du_s)
            bw["dzf"][0].copy_(x.top)
            bw["dzb"][0].copy_(x.top)
            dws = [torch.zeros(w.shape, device=dev) for w in ws] if keep else None
            dbs = [torch.zeros(b.shape, device=dev) for b in nets.fine32.bs] if keep else None
            return bw, dws, dbs

        def fused(o, m=m, keep=keep, x=x, buf=buf):
            FT.cuda_trunk_backward(lib, m, x.e, ws, wts, tm, buf, o[0], o[1], o[2], keep, 0,
                                   scratch, stream)

        def split(o, m=m, keep=keep, x=x, buf=buf):
            FT.cuda_trunk_backward_split(lib, m, x.e, ws, wts, tm, buf, o[0], o[1], o[2], keep,
                                         0, scratch, stream)

        def plain_chains(x=x, m=m):
            rows = x.cs + [x.c_last]
            ds, dms = FT.trunk_ut_plain(x.du, x.du_s, m, ws, x.ss, rows, tm, keep=True)
            return ds, dms, FT.trunk_dz_plain(x.top, m, ws, x.ss, ds, tm, keep=True)

        o1, o2, sp = fresh(), fresh(), fresh()
        fused(o1)
        fused(o2)
        split(sp)
        ds_p, dms_p, (de_p, dzs_p) = plain_chains()
        ref = trunk_bwd_f64(torch, x, ws, tm, keep)
        torch.cuda.synchronize()
        k_items = [("de", o1[0]["de"])] + [(f"ds[{l}]", o1[0]["ds"][l]) for l in range(n - 1)]
        p_items = [("de", de_p)] + [(f"ds[{l}]", ds_p[l]) for l in range(n - 1)]
        s_items = [("de", sp[0]["de"])] + [(f"ds[{l}]", sp[0]["ds"][l]) for l in range(n - 1)]
        r_items = [("de", ref["de"])] + [(f"ds[{l}]", ref["ds"][l]) for l in range(n - 1)]
        kept = []
        if keep:
            e64 = x.e
            ins = [e64] + [torch.cat([a, e64], 1) * FT.INV_SQRT2 if l == tm.skip else a
                           for l, a in zip(range(1, n), x.acts)]
            T = x.ts[:n - 1] + [x.onehot]
            dm0 = [x.du] + [torch.cat([dms_p[l], x.du_s], 1) if l == tm.skip else dms_p[l]
                            for l in range(1, n)]
            dws_p = [dm0[l].T @ T[l] + ins[l].T @ dzs_p[l] for l in range(n)]
            dbs_p = [dzs_p[l].sum(0) for l in range(n)]
            for name, got, want, split_, f64 in (("dW", o1[1], dws_p, sp[1], ref["dws"]),
                                                 ("db", o1[2], dbs_p, sp[2], ref["dbs"])):
                for l in range(n):
                    k_items.append((f"{name}[{l}]", got[l]))
                    p_items.append((f"{name}[{l}]", want[l]))
                    s_items.append((f"{name}[{l}]", split_[l]))
                    r_items.append((f"{name}[{l}]", f64[l]))
            kept = ([(f"dm[{l}]", o1[0]["dms"][l], dms_p[l]) for l in range(1, n)]
                    + [(f"dz[{l}]", o1[0]["dzs"][l], dzs_p[l]) for l in range(n - 1)])
        pairs = [(w, g, p) for (w, g), (_, p) in zip(k_items, p_items)] + kept
        checks = [compare(torch, what, got, want, TOL_F32, TOL_F32) for what, got, want in pairs]
        rule = max(max(rd[0], rd[2]) / (TOL_F32 * rd[3]) if rd[3] > 0 else 0.0
                   for rd in (err_readings(torch, got, want) for _, got, want in pairs))

        def l2(got, r):
            return float((got.double() - r).norm()) / max(float(r.norm()), 1e-300)

        k_l2 = [l2(g, r) for (_, g), (_, r) in zip(k_items, r_items)]
        s_l2 = [l2(g, r) for (_, g), (_, r) in zip(s_items, r_items)]
        mine = [o1[0]["de"], o1[0]["ds"]] + ([*o1[0]["dms"][1:], *o1[0]["dzs"], *o1[1], *o1[2]]
                                             if keep else [])
        again = [o2[0]["de"], o2[0]["ds"]] + ([*o2[0]["dms"][1:], *o2[0]["dzs"], *o2[1], *o2[2]]
                                              if keep else [])
        same = all(torch.equal(a, b) for a, b in zip(mine, again))
        worst_k, worst_s = max(k_l2), max(s_l2)
        r = SimpleNamespace(m=m, keep=keep, count=count, checks=checks, same=same, rule=rule,
                            worst_k=worst_k, worst_s=worst_s,
                            l2_ratio=worst_k / (TOL_TRUNK32_VS_SPLIT * max(worst_s, 1e-30)),
                            worst_what=k_items[k_l2.index(worst_k)][0],
                            max_abs=max(c[1] for c in checks),
                            ok=all(c[0] for c in checks) and same
                            and worst_k <= TOL_TRUNK32_VS_SPLIT * worst_s,
                            ut_ms=None, dz_ms=None, ms=None, split_ms=None, plain_ms=None,
                            ut_plain_ms=None, dz_plain_ms=None, bound_ms=None, bound_by=None,
                            ut_bound_ms=None, dz_bound_ms=None)
        if timed:
            H, E = cfg.d_hidden, cfg.input_width
            dims = trunk_dims(cfg, cfg.d_out)
            ut_flops = 2.0 * m * sum(i * o for i, o in dims[:-1])
            dz_flops = 2.0 * m * sum(i * o for i, o in dims)
            w_bytes = nbytes(ws)
            row = 4 * m * Hp
            ut_bytes = (2 * 4 * m * Ep + nbytes(ws[:n - 1]) + 4 * Hp + (n - 1) * row
                        + (n - 2) * row + (n - 1) * row + (keep and (n - 1) * row))
            dz_bytes = (4 * m * Op + w_bytes + 2 * (n - 1) * row + 4 * m * Ep
                        + (keep and (n - 1) * row))
            bw, _, _ = o1
            dms, dzs = (bw["dms"], bw["dzs"]) if keep else (None, None)
            r.ut_ms = cuda_ms(torch, lambda: FT.trunk_ut(
                m, ws, tm, bw["du_b"], bw["du_s"], x.ss, x.cs, bw["c_last"], bw["ds"], dms,
                stream), 10)
            r.dz_ms = cuda_ms(torch, lambda: FT.trunk_dz(
                m, ws, tm, bw["dzf"][0], x.ss, bw["ds"], bw["de"], dzs, stream), 10)
            r.ms = r.ut_ms + r.dz_ms
            chain = fresh(keep=False)
            r.split_ms = cuda_ms(torch, lambda: split(chain, keep=False), 5)
            r.ut_plain_ms = cuda_ms(torch, lambda: FT.trunk_ut_plain(
                x.du, x.du_s, m, ws, x.ss, x.cs + [x.c_last], tm, keep=keep), 2)
            r.dz_plain_ms = cuda_ms(torch, lambda: FT.trunk_dz_plain(
                x.top, m, ws, x.ss, ds_p, tm, keep=keep), 2)
            r.plain_ms = r.ut_plain_ms + r.dz_plain_ms
            peak = PEAK_F32_3XTF32_FLOPS
            r.ut_bound_ms, _ = bound(ut_flops, ut_bytes, peak)
            r.dz_bound_ms, _ = bound(dz_flops, dz_bytes, peak)
            r.bound_ms, r.bound_by = bound(ut_flops + dz_flops, ut_bytes + dz_bytes, peak)
            del chain
        del o1, o2, sp, ref, x, buf, pairs, k_items, p_items, s_items, r_items, kept
        torch.cuda.empty_cache()
        out.append(r)
    return out


def trunk_bwd32_text(r) -> str:
    """One reading of trunk_bwd32_readings as a log line."""
    what = f"m {r.m} keep {r.keep}" + (f" x{r.count}" if r.count > 1 else "")
    worst = max(r.checks, key=lambda c: c[1])[2]
    text = (f"{what}: {len(r.checks)} outputs within the f32 rule: "
            f"{all(c[0] for c in r.checks)} (the worst: {worst}); a rerun's bits {r.same}; "
            f"L2 vs f64 worst {r.worst_k:.2e} ({r.worst_what}), the split launches' "
            f"{r.worst_s:.2e} (tol {TOL_TRUNK32_VS_SPLIT:g}x)")
    if r.ms is not None:
        text += (f"; up {r.ut_ms:.4f} ms (bound {r.ut_bound_ms:.4f}), down {r.dz_ms:.4f} ms "
                 f"(bound {r.dz_bound_ms:.4f}), the chain {r.ms:.4f} ms against the split "
                 f"launches' {r.split_ms:.4f} ms, plain {r.plain_ms:.3f} ms, bound "
                 f"{r.bound_ms:.4f} ms ({r.bound_by}): {r.bound_ms / r.ms:.2f} of it")
    return text + ("" if r.ok else " FAIL")


def trunk_dw32_calls(calls):
    """The recorded weight-gradient launches (record_trunk_calls) as (m,
    color)."""
    return [(c[1], c[2]) for c in calls if c[0] == "dw"]


def ragged_trunk_dw32_calls():
    """The weight gradients' launch at sizes the main path's leave out,
    with and without K3's color rows."""
    return [(m, color) for m in (1, 63, 64, 65, 1001, 65613) for color in (False, True)]


def trunk_dw32_inputs(torch, dev, nets, m, color: bool):
    """The rows one f32 pass's weight gradients read at m points: the
    trunk's (trunk_bwd32_inputs, and the chains' kept dm and dz rows from
    their plain versions, each list the planes of one tensor) and, with
    color, K3's color rows (seeded: [feat | grad-PE], the kept relu
    activations, one dz row a color layer)."""
    from honerf_torch.ops import fused_fine as FT

    tm, ws = nets.fine32.meta.trunk_meta, nets.fine32.ws
    n = tm.n_layers
    x = trunk_bwd32_inputs(torch, dev, nets, m)
    ds, dms = FT.trunk_ut_plain(x.du, x.du_s, m, ws, x.ss, x.cs + [x.c_last], tm, keep=True)
    _, dzs = FT.trunk_dz_plain(x.top, m, ws, x.ss, ds, tm, keep=True)
    rows = dict(du_b=x.du, du_s=x.du_s, e=x.e, dms=[None] + list(torch.stack(dms[1:n]).unbind(0)),
                dzs=list(torch.stack(dzs[:n - 1]).unbind(0)), acts=x.acts, ts=x.ts, top=x.top,
                onehot=x.onehot)
    crow = None
    if color:
        pack = nets.fine32
        meta, cw, c = pack.meta, pack.cws[0].shape[1], len(pack.cws)
        gen = torch.Generator(device=dev).manual_seed(m + 1)
        crow = dict(cx2=torch.randn((m, meta.Fp + meta.Gp), device=dev, generator=gen),
                    cacts=list(torch.relu(torch.randn((c - 1, m, cw), device=dev,
                                                      generator=gen)).unbind(0)),
                    cdz=list((torch.randn((c, m, cw), device=dev, generator=gen)
                              * 1e-2).unbind(0)))
    return rows, crow


def trunk_dw64(torch, m, tm, rows, crow, cws):
    """trunk_dw_plain's gradients in f64 on the same f32 rows (dW, db of
    each trunk layer, then of each color layer; cws: the color gradients'
    shapes)."""
    n, skip, inv = tm.n_layers, tm.skip, 1.0 / 2 ** 0.5

    def d(x):
        return x[:m].double()

    du_b, du_s, e = d(rows["du_b"]), d(rows["du_s"]), d(rows["e"])
    dw, db = [], []
    for l in range(n):
        dz = d(rows["top"]) if l == n - 1 else d(rows["dzs"][l])
        x = e if l == 0 else (torch.cat([d(rows["acts"][l - 1]), e], 1) * inv if l == skip
                              else d(rows["acts"][l - 1]))
        w = x.T @ dz
        if l == n - 1:
            w[:, 0] += d(rows["dms"][l]).sum(0)
        else:
            dm = du_b if l == 0 else (torch.cat([d(rows["dms"][l]), du_s], 1) if l == skip
                                      else d(rows["dms"][l]))
            w = dm.T @ d(rows["ts"][l]) + w
        dw.append(w)
        db.append(dz.sum(0))
    cw, cb = [], []
    for l, shape in enumerate(cws if crow is not None else []):
        a = torch.cat([e, d(crow["cx2"])], 1) if l == 0 else d(crow["cacts"][l - 1])
        dz = d(crow["cdz"][l])[:, :shape[1]]
        cw.append(a.T @ dz)
        cb.append(dz.sum(0))
    return dw, db, cw, cb


def trunk_dw32_readings(torch, dev, nets, calls, timed: bool = True):
    """trunk_dw_f32_kernel at each distinct (m, color) of `calls`
    (trunk_dw32_calls), weighted by its count, on the flagship's f32 trunk
    and color net (trunk32_nets) at trunk_dw32_inputs: every dW and db
    (with color every dcW and dcb) into NaN-filled gradients against
    trunk_dw_plain on the card under the f32 rule (TOL_F32 of each output's
    range at the median and the max), a second run's bits, and the
    relative L2 of each to f64 (trunk_dw64) beside the split sequence's
    (fused_fine.cuda_trunk_dw_split: a gemm_tn_f32_kernel and its
    reduce_partials_kernel a product, a colsum_partial_kernel a layer) at
    the same call, the launch's worst within TOL_TRUNK32_VS_SPLIT of the
    split's worst.  timed: ms of the launch and of the split sequence in
    turns (launch, split, split, launch), of the plain version, and the
    bound (3xTF32 operations of the unpadded products, the u-chain's and the
    forward's, the last layer's one-hot product left out; each row read
    once, each gradient written once)."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF

    stream = torch.cuda.current_stream(dev).cuda_stream
    nan = float("nan")
    pack, cfg = nets.fine32, nets.cfg
    tm, meta = pack.meta.trunk_meta, pack.meta
    lib = FF._bwd_lib()
    scratch = torch.empty((FT._WS_FLOATS,), device=dev)
    cws = [tuple(w.shape) for w in pack.cws]
    out = []
    for (m, color), count in _tally(calls).items():
        rows, crow = trunk_dw32_inputs(torch, dev, nets, m, color)

        def fresh(color=color, crow=crow):
            full = lambda ts: [torch.full(t.shape, nan, device=dev) for t in ts]  # noqa: E731
            c = None if not color else dict(crow, dcws=full(pack.cws), dcbs=full(pack.cbs))
            return full(pack.ws), full(pack.bs), c

        def grads(o):
            return list(o[0]) + list(o[1]) + ([] if o[2] is None else o[2]["dcws"]
                                              + o[2]["dcbs"])

        def fused(o, m=m, rows=rows):
            FT.trunk_dw(m, tm, rows, o[0], o[1], 0, stream, o[2])

        def split(o, m=m, rows=rows):
            FT.cuda_trunk_dw_split(lib, m, tm, rows, o[0], o[1], 0, scratch, stream, o[2])

        def plain(o, m=m, rows=rows):
            FT.trunk_dw_plain(m, tm, rows, o[0], o[1], 0, o[2])

        o1, o2, sp, pl = fresh(), fresh(), fresh(), fresh()
        fused(o1)
        fused(o2)
        split(sp)
        plain(pl)
        dw64, db64, cw64, cb64 = trunk_dw64(torch, m, tm, rows, crow, cws)
        ref = dw64 + db64 + cw64 + cb64
        torch.cuda.synchronize()
        n = tm.n_layers
        names = ([f"dW[{l}]" for l in range(n)] + [f"db[{l}]" for l in range(n)]
                 + ([f"dcW[{l}]" for l in range(len(cws))] + [f"dcb[{l}]" for l in range(len(cws))]
                    if color else []))
        got, want, spl = grads(o1), grads(pl), grads(sp)
        checks = [compare(torch, w, g, p, TOL_F32, TOL_F32) for w, g, p in zip(names, got, want)]
        rule = max(max(rd[0], rd[2]) / (TOL_F32 * rd[3]) if rd[3] > 0 else 0.0
                   for rd in (err_readings(torch, g, p) for g, p in zip(got, want)))

        def l2(g, r):
            return float((g.double() - r).norm()) / max(float(r.norm()), 1e-300)

        k_l2 = [l2(g, r) for g, r in zip(got, ref)]
        s_l2 = [l2(g, r) for g, r in zip(spl, ref)]
        same = all(torch.equal(a, b) for a, b in zip(got, grads(o2)))
        worst_k, worst_s = max(k_l2), max(s_l2)
        r = SimpleNamespace(m=m, color=color, count=count, checks=checks, same=same, rule=rule,
                            worst_k=worst_k, worst_s=worst_s,
                            l2_ratio=worst_k / (TOL_TRUNK32_VS_SPLIT * max(worst_s, 1e-30)),
                            worst_what=names[k_l2.index(worst_k)],
                            max_abs=max(c[1] for c in checks),
                            ok=all(c[0] for c in checks) and same
                            and worst_k <= TOL_TRUNK32_VS_SPLIT * worst_s,
                            ms=None, split_ms=None, turns=None, plain_ms=None, bound_ms=None,
                            bound_by=None)
        if timed:
            dims = trunk_dims(cfg, cfg.d_out)
            flops = 2.0 * m * (2 * sum(i * o for i, o in dims[:-1]) + dims[-1][0] * dims[-1][1])
            n_bytes = 4 * m * (3 * tm.Ep + 4 * (n - 1) * tm.Hp + tm.Op) + nbytes(got[:2 * n])
            if color:
                c_in = ([meta.emb_width + meta.d_out - 1 + 3 + 6 * meta.grad_L]
                        + [meta.c_hidden] * (meta.c_layers - 1))
                c_out = [meta.c_hidden] * (meta.c_layers - 1) + [3]
                flops += 2.0 * m * sum(i * o for i, o in zip(c_in, c_out))
                n_bytes += (4 * m * (crow["cx2"].shape[1] + sum(t.shape[1] for t in crow["cacts"])
                                     + sum(w[1] for w in cws)) + nbytes(got[2 * n:]))
            o = fresh()
            turns = (cuda_ms(torch, lambda: fused(o), 5), cuda_ms(torch, lambda: split(sp), 5),
                     cuda_ms(torch, lambda: split(sp), 5), cuda_ms(torch, lambda: fused(o), 5))
            r.turns = turns
            r.ms, r.split_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            r.plain_ms = cuda_ms(torch, lambda: plain(pl), 2)
            r.bound_ms, r.bound_by = bound(flops, n_bytes, PEAK_F32_3XTF32_FLOPS)
            del o
        del o1, o2, sp, pl, ref, rows, crow, got, want, spl
        torch.cuda.empty_cache()
        out.append(r)
    return out


def trunk_dw32_text(r) -> str:
    """One reading of trunk_dw32_readings as a log line."""
    what = f"m {r.m} color {r.color}" + (f" x{r.count}" if r.count > 1 else "")
    worst = max(r.checks, key=lambda c: c[1])[2]
    text = (f"{what}: {len(r.checks)} gradients within the f32 rule: "
            f"{all(c[0] for c in r.checks)} (the worst: {worst}); a rerun's bits {r.same}; "
            f"L2 vs f64 worst {r.worst_k:.2e} ({r.worst_what}), the split sequence's "
            f"{r.worst_s:.2e} (tol {TOL_TRUNK32_VS_SPLIT:g}x)")
    if r.ms is not None:
        text += (f"; the launch {r.ms:.4f} ms against the split sequence's {r.split_ms:.4f} ms "
                 f"({r.ms / r.split_ms:.2f} of it; in turns "
                 + ", ".join(f"{t:.4f}" for t in r.turns)
                 + f"), plain {r.plain_ms:.3f} ms, bound {r.bound_ms:.4f} ms ({r.bound_by}): "
                 f"{r.bound_ms / r.ms:.2f} of it")
    return text + ("" if r.ok else " FAIL")


def color32_calls(calls):
    """The recorded f32 color launches (record_trunk_calls) as (kind, m,
    flag): ("cfwd", m, keep) and ("cbwd", m, dz)."""
    return [c[:3] for c in calls if c[0] in ("cfwd", "cbwd")]


def ragged_color32_calls():
    """The f32 color pair at sizes the main path's leave out, each output
    mode: the forward with and without the relu rows, the transpose with
    and without the dz rows."""
    return [(kind, m, flag) for m in (1, 63, 64, 65, 1001, 65613)
            for kind in ("cfwd", "cbwd") for flag in (False, True)]


def color32_inputs(torch, dev, nets, m):
    """The f32 color net's inputs at m points: e the f32 embedding of nets'
    first m points (hand_embed_kernel), seeded cx2 ([feat | grad-PE]) and
    dcolor, and the plain forward's sigmoid (packed[:, 4:7]) and relu rows
    (cacts, the planes of one tensor), which the transpose reads."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF
    from honerf_torch.ops import fused_hand as FH

    pack = nets.fine32
    meta, f32 = pack.meta, torch.float32
    e = torch.empty((m, meta.trunk_meta.Ep), device=dev, dtype=f32)
    FH.embed(FH._lib("fused_hand"), nets.pts, m, *nets.pose, meta.v_multires, meta.r_multires,
             e, torch.cuda.current_stream(dev).cuda_stream)
    gen = torch.Generator(device=dev).manual_seed(m + 7)
    cx2 = torch.randn((m, meta.Fp + meta.Gp), device=dev, generator=gen)
    dcolor = torch.randn((m, 3), device=dev, generator=gen)
    color, acts = FF.color_fwd_plain(e, cx2, m, pack.cws, pack.cbs, meta)
    packed = torch.zeros((m, 8), device=dev)
    packed[:, 4:7] = color
    cacts = FT.planes(len(acts), m, pack.cws[0].shape[1], dev, f32)
    for dst, a in zip(cacts, acts):
        dst.copy_(a)
    return SimpleNamespace(e=e, cx2=cx2, dcolor=dcolor, packed=packed, cacts=cacts)


def color64(torch, m, pack, x):
    """The color net in f64 on the same f32 inputs: the forward's [color,
    relu rows ...] from [e | cx2], and the transpose's [dx, dz rows ...] at
    x.packed's sigmoid and x.cacts' masks."""
    meta = pack.meta
    n = meta.c_layers
    a = torch.cat([x.e[:m].double(), x.cx2[:m].double()], 1)
    acts = []
    for l, (w, b) in enumerate(zip(pack.cws, pack.cbs)):
        z = a @ w.double() + b.double()
        if l + 1 < n:
            a = torch.relu(z)
            acts.append(a)
    s = x.packed[:m, 4:7].double()
    dz = torch.nn.functional.pad(s * (1.0 - s) * x.dcolor[:m].double(),
                                 (0, pack.cws[-1].shape[1] - 3))
    dzs = [None] * n
    for l in range(n - 1, -1, -1):
        dzs[l] = dz
        da = dz @ pack.cws[l].double().T
        if l:
            dz = torch.where(x.cacts[l - 1][:m] > 0, da, 0.0)
    return [torch.sigmoid(z[:, :3])] + acts, [da] + dzs


def color32_readings(torch, dev, nets, calls, timed: bool = True):
    """color_fwd_f32_kernel ("cfwd") and color_bwd_f32_kernel ("cbwd") at
    each distinct call of `calls` (color32_calls), weighted by its count,
    on the flagship's f32 color net (trunk32_nets) at color32_inputs: every
    output (the color and with keep the relu rows; dx and with dz the dz
    rows) into NaN-filled buffers against the plain versions on the card
    under the f32 rule (TOL_F32 of each output's range at the median and
    the max), a second run's bits, and the relative L2 of each to f64
    (color64) beside the split launches' (fused_fine_full._color_fwd_split
    / _color_bwd_split: one gemm_f32_kernel a layer, color_dz_kernel first
    in the transpose) at the same call, the kernel's worst within
    TOL_TRUNK32_VS_SPLIT of the split's worst.  timed: ms of the kernel and
    of the split launches in turns (kernel, split, split, kernel), of the
    plain version, and the bound (3xTF32 operations of the unpadded
    products; each input read once, each output written once)."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF

    stream = torch.cuda.current_stream(dev).cuda_stream
    nan, f32 = float("nan"), torch.float32
    pack = nets.fine32
    meta = pack.meta
    n, H, top = meta.c_layers, pack.cws[0].shape[1], pack.cws[-1].shape[1]
    lib, blib = FF._lib(), FF._bwd_lib()
    c_in = ([meta.emb_width + meta.d_out - 1 + 3 + 6 * meta.grad_L]
            + [meta.c_hidden] * (meta.c_layers - 1))
    c_out = [meta.c_hidden] * (meta.c_layers - 1) + [3]
    w_bytes = nbytes([*pack.cws, *pack.cbs])
    out = []
    for (kind, m, flag), count in _tally(calls).items():
        x = color32_inputs(torch, dev, nets, m)
        fwd = kind == "cfwd"

        def planes(k, m=m):
            return [p.fill_(nan) for p in FT.planes(k, m, H, dev, f32)]

        def fresh(fwd=fwd, flag=flag, m=m):
            if fwd:
                return SimpleNamespace(packed=torch.full((m, 8), nan, device=dev),
                                       cacts=planes(n - 1) if flag else None)
            return SimpleNamespace(dx=torch.full((m, meta.color_in), nan, device=dev),
                                   cdz=planes(n) if flag else None)

        def outs(o, fwd=fwd, flag=flag):
            if fwd:
                return [o.packed[:, 4:7]] + (list(o.cacts) if flag else [])
            return [o.dx] + ([z[:, :w.shape[1]] for z, w in zip(o.cdz, pack.cws)]
                             if flag else [])

        def fused(o, fwd=fwd, m=m, x=x):
            if fwd:
                FF.color_fwd_f32(x.e, x.cx2, m, pack.cws, pack.cbs, meta, o.packed, o.cacts,
                                 stream)
            else:
                FF.color_bwd_f32(m, pack.cws, meta, x.packed, x.dcolor, x.cacts, o.dx, o.cdz,
                                 stream)

        def split(o, fwd=fwd, m=m, x=x):
            if fwd:
                FF._color_fwd_split(lib, x.e, x.cx2, m, pack, o.packed, stream, o.cacts)
            else:   # the split launches form every dz row
                if o.cdz is None:
                    o.cdz = planes(n)
                FF._color_bwd_split(blib, m, pack, dict(e=x.e, cx2=x.cx2, cacts=x.cacts),
                                    x.packed, x.dcolor, o.dx, o.cdz, stream)

        def plain(fwd=fwd, flag=flag, m=m, x=x):
            if fwd:
                color, acts = FF.color_fwd_plain(x.e, x.cx2, m, pack.cws, pack.cbs, meta)
                return [color] + (acts if flag else [])
            dx, dzs = FF.color_bwd_plain(m, pack.cws, meta, x.packed, x.dcolor, x.cacts)
            return [dx] + (dzs if flag else [])

        o1, o2, sp = fresh(), fresh(), fresh()
        fused(o1)
        fused(o2)
        split(sp)
        want = plain()
        ref = color64(torch, m, pack, x)[0 if fwd else 1]
        torch.cuda.synchronize()
        names = ((["color"] + [f"relu[{l}]" for l in range(n - 1)]) if fwd
                 else (["dx"] + [f"dz[{l}]" for l in range(n)]))
        got, spl = outs(o1), outs(sp, flag=flag or not fwd)
        checks = [compare(torch, w, g, p, TOL_F32, TOL_F32) for w, g, p in zip(names, got, want)]
        rule = max(max(rd[0], rd[2]) / (TOL_F32 * rd[3]) if rd[3] > 0 else 0.0
                   for rd in (err_readings(torch, g, p) for g, p in zip(got, want)))

        def l2(g, r):
            return float((g.double() - r).norm()) / max(float(r.norm()), 1e-300)

        k_l2 = [l2(g, r) for g, r in zip(got, ref)]
        s_l2 = [l2(g, r) for g, r in zip(spl, ref)][:len(got)]
        same = all(torch.equal(a, b) for a, b in zip(got, outs(o2)))
        worst_k, worst_s = max(k_l2), max(s_l2)
        r = SimpleNamespace(kind=kind, m=m, flag=flag, count=count, checks=checks, same=same,
                            rule=rule, worst_k=worst_k, worst_s=worst_s,
                            l2_ratio=worst_k / (TOL_TRUNK32_VS_SPLIT * max(worst_s, 1e-30)),
                            worst_what=names[k_l2.index(worst_k)],
                            max_abs=max(c[1] for c in checks),
                            ok=all(c[0] for c in checks) and same
                            and worst_k <= TOL_TRUNK32_VS_SPLIT * worst_s,
                            ms=None, split_ms=None, turns=None, plain_ms=None, bound_ms=None,
                            bound_by=None)
        if timed:
            flops = 2.0 * m * sum(i * o for i, o in zip(c_in, c_out))
            if fwd:
                n_bytes = 4 * m * (x.e.shape[1] + x.cx2.shape[1] + 3
                                   + ((n - 1) * H if flag else 0)) + w_bytes
            else:
                n_bytes = (4 * m * (6 + (n - 1) * H + meta.color_in
                                    + ((n - 1) * H + top if flag else 0)) + w_bytes)
            o = fresh()
            turns = (cuda_ms(torch, lambda: fused(o), 5), cuda_ms(torch, lambda: split(sp), 5),
                     cuda_ms(torch, lambda: split(sp), 5), cuda_ms(torch, lambda: fused(o), 5))
            r.turns = turns
            r.ms, r.split_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            r.plain_ms = cuda_ms(torch, plain, 2)
            r.bound_ms, r.bound_by = bound(flops, n_bytes, PEAK_F32_3XTF32_FLOPS)
            del o
        del o1, o2, sp, want, ref, got, spl, x
        torch.cuda.empty_cache()
        out.append(r)
    return out


def color32_text(r) -> str:
    """One reading of color32_readings as a log line."""
    what = (f"{'forward' if r.kind == 'cfwd' else 'transpose'} m {r.m} "
            f"{'keep' if r.kind == 'cfwd' else 'dz'} {r.flag}"
            + (f" x{r.count}" if r.count > 1 else ""))
    worst = max(r.checks, key=lambda c: c[1])[2]
    text = (f"{what}: {len(r.checks)} outputs within the f32 rule: "
            f"{all(c[0] for c in r.checks)} (the worst: {worst}); a rerun's bits {r.same}; "
            f"L2 vs f64 worst {r.worst_k:.2e} ({r.worst_what}), the split launches' "
            f"{r.worst_s:.2e} (tol {TOL_TRUNK32_VS_SPLIT:g}x)")
    if r.ms is not None:
        text += (f"; the kernel {r.ms:.4f} ms against the split launches' {r.split_ms:.4f} ms "
                 f"({r.ms / r.split_ms:.2f} of it; in turns "
                 + ", ".join(f"{t:.4f}" for t in r.turns)
                 + f"), plain {r.plain_ms:.3f} ms, bound {r.bound_ms:.4f} ms ({r.bound_by}): "
                 f"{r.bound_ms / r.ms:.2f} of it")
    return text + ("" if r.ok else " FAIL")


def color16_calls(calls):
    """The recorded bf16 color launches (record_trunk_calls) as (kind, m,
    flag): ("cfwd16", m, keep) and ("cbwd16", m, dz)."""
    return [c[:3] for c in calls if c[0] in ("cfwd16", "cbwd16")]


def ragged_color16_calls():
    """The bf16 color pair at sizes the main path's leave out, each output
    mode: the forward with and without the relu rows, the transpose with
    and without the dz rows."""
    return [(kind, m, flag) for m in (1, 63, 64, 65, 1001, 65613)
            for kind in ("cfwd16", "cbwd16") for flag in (False, True)]


def color16_inputs(torch, dev, nets, m):
    """The bf16 color net's inputs at m points: e the bf16 embedding of
    nets' first m points (hand_embed_kernel), seeded bf16 cx2 ([feat |
    grad-PE]) and f32 dcolor, and the plain forward's sigmoid (packed[:,
    4:7]) and bf16 relu rows (cacts, the planes of one tensor), which the
    transpose reads."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF
    from honerf_torch.ops import fused_hand as FH

    pack = nets.fine
    meta, bf16 = pack.meta, torch.bfloat16
    e = torch.empty((m, meta.trunk_meta.Ep), device=dev, dtype=bf16)
    FH.embed(FH._lib("fused_hand"), nets.pts, m, *nets.pose, meta.v_multires, meta.r_multires,
             e, torch.cuda.current_stream(dev).cuda_stream)
    gen = torch.Generator(device=dev).manual_seed(m + 7)
    cx2 = torch.randn((m, meta.Fp + meta.Gp), device=dev, generator=gen).to(bf16)
    dcolor = torch.randn((m, 3), device=dev, generator=gen)
    color, acts = FF.color_fwd_plain(e, cx2, m, pack.cws, pack.cbs, meta)
    packed = torch.zeros((m, 8), device=dev)
    packed[:, 4:7] = color
    cacts = FT.planes(len(acts), m, pack.cws[0].shape[1], dev, bf16)
    for dst, a in zip(cacts, acts):
        dst.copy_(a)
    return SimpleNamespace(e=e, cx2=cx2, dcolor=dcolor, packed=packed, cacts=cacts)


def sha256(torch, t) -> str:
    """SHA-256 of a tensor's bytes (a contiguous copy on the host)."""
    import hashlib

    return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def color16_readings(torch, dev, nets, calls, timed: bool = True):
    """color_fwd_kernel ("cfwd16") and color_bwd_kernel ("cbwd16") at each
    distinct call of `calls` (color16_calls), weighted by its count, on the
    flagship's bf16 color net (trunk_nets) at color16_inputs: every output
    (the color and with keep the relu rows; dx and with dz the dz rows in
    f32 and bf16) into NaN-filled buffers against the plain versions on the
    card under the kernel rule (TOL_MEDIAN, TOL_MAX of each output's
    range), a second run's bits, and each output's SHA-256 against the
    split launches' (fused_fine_full._color_fwd_split / _color_bwd_split:
    one gemm_kernel a layer, color_dz_kernel first in the transpose) at the
    same call; where bits move, the relative L2 of each to f64 (color64)
    within TOL_TRUNK32_VS_SPLIT of the split's.  timed: ms of the kernel and
    of the split launches in turns (kernel, split, split, kernel), of the
    plain version, and the bound (bf16 operations of the unpadded
    products; each input read once, each output written once)."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF

    stream = torch.cuda.current_stream(dev).cuda_stream
    nan, f32, bf16 = float("nan"), torch.float32, torch.bfloat16
    pack = nets.fine
    meta = pack.meta
    n, H, top = meta.c_layers, pack.cws[0].shape[1], pack.cws[-1].shape[1]
    widths = [w.shape[1] for w in pack.cws]
    lib, blib = FF._lib(), FF._bwd_lib()
    c_in = ([meta.emb_width + meta.d_out - 1 + 3 + 6 * meta.grad_L]
            + [meta.c_hidden] * (meta.c_layers - 1))
    c_out = [meta.c_hidden] * (meta.c_layers - 1) + [3]
    w_bytes = nbytes([*pack.cws, *pack.cbs])
    out = []
    for (kind, m, flag), count in _tally(calls).items():
        x = color16_inputs(torch, dev, nets, m)
        fwd = kind == "cfwd16"

        def planes(k, dtype, m=m):
            return [p.fill_(nan) for p in FT.planes(k, m, H, dev, dtype)]

        def fresh(fwd=fwd, flag=flag, m=m):
            if fwd:
                return SimpleNamespace(packed=torch.full((m, 8), nan, device=dev),
                                       cacts=planes(n - 1, bf16) if flag else None)
            return SimpleNamespace(dx=torch.full((m, meta.color_in), nan, device=dev),
                                   cdz=planes(n, f32) if flag else None,
                                   cdzb=planes(n, bf16) if flag else None)

        def outs(o, fwd=fwd, flag=flag):
            if fwd:
                return [o.packed[:, 4:7]] + (list(o.cacts) if flag else [])
            return [o.dx] + ([z[:, :w] for z, w in zip(o.cdz + o.cdzb, widths + widths)]
                             if flag else [])

        def fused(o, fwd=fwd, m=m, x=x):
            if fwd:
                FF.color_fwd(x.e, x.cx2, m, pack.cws, pack.cbs, meta, o.packed, o.cacts, stream)
            else:
                FF.color_bwd(m, pack.cws, pack.cwts, meta, x.packed, x.dcolor, x.cacts, o.dx,
                             o.cdz, o.cdzb, stream)

        def split(o, fwd=fwd, m=m, x=x):
            if fwd:
                FF._color_fwd_split(lib, x.e, x.cx2, m, pack, o.packed, stream, o.cacts)
            else:   # the split launches form every dz row
                if o.cdz is None:
                    o.cdz, o.cdzb = planes(n, f32), planes(n, bf16)
                FF._color_bwd_split(blib, m, pack, dict(e=x.e, cx2=x.cx2, cacts=x.cacts),
                                    x.packed, x.dcolor, o.dx, o.cdz, stream, o.cdzb)

        def plain(fwd=fwd, flag=flag, m=m, x=x):
            if fwd:
                color, acts = FF.color_fwd_plain(x.e, x.cx2, m, pack.cws, pack.cbs, meta)
                return [color] + (acts if flag else [])
            dx, dzs = FF.color_bwd_plain(m, pack.cws, meta, x.packed, x.dcolor, x.cacts)
            return [dx] + (dzs + [z.to(bf16) for z in dzs] if flag else [])

        o1, o2, sp = fresh(), fresh(), fresh()
        fused(o1)
        fused(o2)
        split(sp)
        want = plain()
        ref = color64(torch, m, pack, x)
        ref = ref[0] if fwd else ref[1] + ref[1][1:]
        torch.cuda.synchronize()
        names = ((["color"] + [f"relu[{l}]" for l in range(n - 1)]) if fwd
                 else (["dx"] + [f"dz[{l}]" for l in range(n)]
                       + [f"dzb[{l}]" for l in range(n)]))
        got = outs(o1)
        spl = outs(sp, flag=flag or not fwd)[:len(got)]
        checks = [compare(torch, w, g, p) for w, g, p in zip(names, got, want)]
        rule = max(max(rd[0] / TOL_MEDIAN, rd[2] / TOL_MAX) / rd[3]
                   for rd in (err_readings(torch, g, p) for g, p in zip(got, want)))
        if not all(bool(torch.isfinite(g).all()) for g in got):
            rule = float("inf")
        same = all(torch.equal(a, b) for a, b in zip(got, outs(o2)))
        moved = [w for w, g, q in zip(names, got, spl) if sha256(torch, g) != sha256(torch, q)]

        def l2(g, r):
            return float((g.double() - r).norm()) / max(float(r.norm()), 1e-300)

        k_l2 = [l2(g, r) for g, r in zip(got, ref)]
        s_l2 = [l2(g, r) for g, r in zip(spl, ref)]
        worst_k, worst_s = max(k_l2), max(s_l2)
        r = SimpleNamespace(kind=kind, m=m, flag=flag, count=count, checks=checks, same=same,
                            rule=rule, moved=moved, worst_k=worst_k, worst_s=worst_s,
                            worst_what=names[k_l2.index(worst_k)],
                            max_abs=max(c[1] for c in checks),
                            ok=(all(c[0] for c in checks) and same
                                and (not moved or worst_k <= TOL_TRUNK32_VS_SPLIT * worst_s)),
                            ms=None, split_ms=None, turns=None, plain_ms=None, bound_ms=None,
                            bound_by=None)
        if timed:
            flops = 2.0 * m * sum(i * o for i, o in zip(c_in, c_out))
            if fwd:
                n_bytes = (2 * m * (x.e.shape[1] + x.cx2.shape[1]) + 4 * m * 3
                           + (2 * m * (n - 1) * H if flag else 0) + w_bytes)
            else:
                n_bytes = (4 * m * 6 + 2 * m * (n - 1) * H + 4 * m * meta.color_in
                           + (6 * m * ((n - 1) * H + top) if flag else 0) + w_bytes)
            o = fresh()
            turns = (cuda_ms(torch, lambda: fused(o), 5), cuda_ms(torch, lambda: split(sp), 5),
                     cuda_ms(torch, lambda: split(sp), 5), cuda_ms(torch, lambda: fused(o), 5))
            r.turns = turns
            r.ms, r.split_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
            r.plain_ms = cuda_ms(torch, plain, 2)
            r.bound_ms, r.bound_by = bound(flops, n_bytes)
            del o
        del o1, o2, sp, want, ref, got, spl, x
        torch.cuda.empty_cache()
        out.append(r)
    return out


def color16_text(r) -> str:
    """One reading of color16_readings as a log line."""
    what = (f"{'forward' if r.kind == 'cfwd16' else 'transpose'} m {r.m} "
            f"{'keep' if r.kind == 'cfwd16' else 'dz'} {r.flag}"
            + (f" x{r.count}" if r.count > 1 else ""))
    worst = max(r.checks, key=lambda c: c[1])[2]
    text = (f"{what}: {len(r.checks)} outputs within the kernel rule: "
            f"{all(c[0] for c in r.checks)} (the worst: {worst}); a rerun's bits {r.same}; "
            f"SHA-256 against the split launches': "
            + (f"moved for {', '.join(r.moved)}" if r.moved else "every output equal")
            + f"; L2 vs f64 worst {r.worst_k:.2e} ({r.worst_what}), the split launches' "
            f"{r.worst_s:.2e}")
    if r.ms is not None:
        text += (f"; the kernel {r.ms:.4f} ms against the split launches' {r.split_ms:.4f} ms "
                 f"({r.ms / r.split_ms:.2f} of it; in turns "
                 + ", ".join(f"{t:.4f}" for t in r.turns)
                 + f"), plain {r.plain_ms:.3f} ms, bound {r.bound_ms:.4f} ms ({r.bound_by}): "
                 f"{r.bound_ms / r.ms:.2f} of it")
    return text + ("" if r.ok else " FAIL")


def seed_calls(torch):
    """The seed (the f32 trunk's) at sizes the main path's (multiples of a
    block step) leave out: one row, a block step less one (7 at width 256)
    and a ragged 70,001."""
    return [(m, 256, 256, torch.float32) for m in (1, 7, 70001)]


def bwdrev_calls(torch):
    """The reverse-chain transpose at sizes the main path's leave out: one
    point, a tile less one (3 in bf16, 1 in f32) and a ragged 70,001, at
    the flagship's widths (Ep 1408, Op 320, the color input's 1792
    columns)."""
    from honerf_torch.ops import fused_fine_full as FF

    out = []
    for dtype in ("bf16", "f32"):
        meta = FF.FineMeta(v_multires=10, r_multires=7, d_hidden=256, n_layers=9, skip=4,
                           d_out=257, dtype=dtype)
        for m in (1, 3 if dtype == "bf16" else 1, 70001):
            out.append((m, meta, meta.color_in, meta.trunk_meta.Ep, meta.trunk_meta.Op))
    return list(dict.fromkeys(out))


def seed_readings(torch, dev, calls, timed: bool = True):
    """uchain_seed_kernel alone at the recorded calls (record_perpoint_calls),
    each distinct shape once, weighted by its count: on seeded inputs (W_last
    256 x 320 normal x 0.1 in the call's type, s uniform as a sigmoid row),
    into a NaN-filled t, bit for bit against uchain_seed_plain and against
    torch.mul(s[:m], c, out=t) with c = W_last[:, 0] in f32 (one product
    rounded once), the columns past the width untouched.  timed: ms of the
    kernel, its plain version, that torch.mul (the library yardstick; the
    port never calls it) and its bound (s read once, t written once)."""
    from honerf_torch.ops import fused_fine as FT

    lib = FT._lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(23)
    out = []
    for (m, width, ldt, dtype), count in _tally(calls).items():
        w = (0.1 * torch.randn((width, 320), generator=gen, device=dev)).to(dtype)
        s_ = torch.rand((m, width), generator=gen, device=dev)
        t = torch.full((m, ldt), float("nan"), device=dev, dtype=dtype)
        c = w[:, 0].float()
        lt = torch.empty((m, width), device=dev, dtype=dtype)

        def run(w=w, s_=s_, m=m, t=t):
            FT.uchain_seed(lib, w, s_, m, t, stream)

        def library(s_=s_, c=c, lt=lt):
            torch.mul(s_, c, out=lt)

        run()
        library()
        want = FT.uchain_seed_plain(w, s_, m, dtype)
        torch.cuda.synchronize()
        same, same_lib = bool(torch.equal(t[:, :width], want)), bool(torch.equal(t[:, :width], lt))
        rest = bool(torch.isnan(t[:, width:].float()).all())
        r = SimpleNamespace(m=m, width=width, dtype=str(dtype).split(".")[-1], count=count,
                            same=same, same_lib=same_lib, max_abs=float(
                                (t[:, :width].float() - want.float()).abs().max()),
                            ok=same and same_lib and rest, ms=None, plain_ms=None, lib_ms=None,
                            bound_ms=None, bound_by=None)
        if timed:
            r.ms = cuda_ms(torch, run, 20)
            r.plain_ms = cuda_ms(torch, lambda w=w, s_=s_, m=m: FT.uchain_seed_plain(
                w, s_, m, dtype), 5)
            r.lib_ms = cuda_ms(torch, library, 20)
            r.bound_ms, r.bound_by = bound(float(m * width), m * width * (4 + t.element_size())
                                           + width * t.element_size(), PEAK_F32_FLOPS)
        del w, s_, t, lt, want
        out.append(r)
    return out


def bwdrev_bytes(meta, m: int) -> int:
    """The bytes fine_bwd_rev_kernel must move for m points: it writes
    du_b, du_s (Ep of the type each), dzf (Op f32), dzb (Op of the type)
    and dgt's 3 f32, and reads the point (3 f32), g (3), dg (3), dsdf (1),
    dx's F feature columns and 3 (1 + 2 L) grad-PE columns (f32)."""
    tm = meta.trunk_meta
    es = 4 if meta.dtype == "f32" else 2
    writes = 2 * tm.Ep * es + tm.Op * (4 + es) + 12
    reads = 4 * (3 + 3 + 3 + 1 + (meta.d_out - 1) + 3 * (1 + 2 * meta.grad_L))
    return m * (writes + reads)


def bwdrev_readings(torch, dev, pose, pts, calls, timed: bool = True):
    """fine_bwd_rev_kernel alone at the recorded calls, each distinct shape
    once, weighted by its count, on the given points and pose and seeded
    normal packed (g), dsdf, dg and dx, into NaN-filled outputs (an
    unwritten column shows): du_b, du_s and dgt against
    fine_bwd_rev_plain on the same card inputs under the embedding's rule
    in bf16 (TOL_MEDIAN, TOL_MAX of the range), TOL_F32 at the median and
    the max in f32; du's padding exactly 0; dzf and dzb (a copy) exactly.
    timed: ms of the kernel and of its plain version, its bound (bytes,
    bwdrev_bytes; no single PyTorch call computes it)."""
    from honerf_torch.ops import fused_fine_full as FF

    rotT, off, cut = pose
    blib = FF._bwd_lib()
    stream = torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(29)
    out = []
    for (m, meta, ldx, lddu, lddz), count in _tally(calls).items():
        dtype = torch.float32 if meta.dtype == "f32" else torch.bfloat16
        tm = meta.trunk_meta
        packed = torch.randn((m, 8), generator=gen, device=dev)
        dsdf = torch.randn((m,), generator=gen, device=dev)
        dg = torch.randn((m, 3), generator=gen, device=dev)
        dx = torch.randn((m, ldx), generator=gen, device=dev)
        nan = float("nan")
        outs = (torch.full((m, lddu), nan, device=dev, dtype=dtype),
                torch.full((m, lddu), nan, device=dev, dtype=dtype),
                torch.full((m, 4), nan, device=dev),
                torch.full((m, lddz), nan, device=dev),
                torch.full((m, lddz), nan, device=dev, dtype=dtype))

        def run(m=m, meta=meta, packed=packed, dsdf=dsdf, dg=dg, dx=dx, outs=outs):
            FF.fine_bwd_rev(blib, pts, m, rotT, off, cut, meta, packed, dsdf, dg, dx, *outs,
                            stream)

        def plain(m=m, meta=meta, packed=packed, dsdf=dsdf, dg=dg, dx=dx, dtype=dtype):
            return FF.fine_bwd_rev_plain(pts[:m], rotT, off, cut, meta, packed, dsdf, dg, dx,
                                         dtype)

        run()
        want = plain()
        torch.cuda.synchronize()
        tol_med, tol_max = (TOL_F32, TOL_F32) if meta.dtype == "f32" else (TOL_MEDIAN, TOL_MAX)
        res = [compare(torch, name, g, w, tol_med, tol_max)
               for name, g, w in (("du_b", outs[0][:, :tm.Ep], want[0]),
                                  ("du_s", outs[1][:, :tm.Ep], want[1]),
                                  ("dgt", outs[2][:, :3], want[2]))]
        E = meta.emb_width
        pad_ok = bool((outs[0][:, E:tm.Ep] == 0).all()) and bool((outs[1][:, E:tm.Ep] == 0).all())
        dz_ok = (bool(torch.equal(outs[3][:, :tm.Op], want[3]))
                 and bool(torch.equal(outs[4][:, :tm.Op], want[4])))
        text = "; ".join(x[2] for x in res) + f"; padding 0 {pad_ok}; dz exact {dz_ok}"
        r = SimpleNamespace(m=m, dtype=meta.dtype, count=count, max_abs=max(x[1] for x in res),
                            ok=all(x[0] for x in res) and pad_ok and dz_ok, text=text, ms=None,
                            plain_ms=None, bound_ms=None, bound_by=None)
        if timed:
            r.ms = cuda_ms(torch, run, 10)
            r.plain_ms = cuda_ms(torch, plain, 2)
            r.bound_ms, r.bound_by = bound(0.0, bwdrev_bytes(meta, m), PEAK_F32_FLOPS)
        del packed, dsdf, dg, dx, outs, want
        out.append(r)
    return out


def reduce_bound_ms(calls) -> float:
    """The bytes bound of reduce_partials_kernel over a step's dW products
    {(K, N, m, dtype): count}: each product's f32 partials read once and
    its dW written once, the split as ops/fused_fine.py's _tn picks it
    (bf16: wgmma_layout.tn_split over _TN_BLOCKS_BF16 blocks, BM x BN_TN
    tiles; f32: _TN_BLOCKS blocks of 128 x 128 tiles, splits a multiple of
    32 points)."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import wgmma_layout as WL

    up = lambda x, k: -(-x // k) * k  # noqa: E731
    total = 0.0
    for (K, N, m, dt), count in calls.items():
        if str(dt) == "torch.float32":
            tiles = -(-K // FT._TN_TILE) * -(-N // FT._TN_TILE)
            splits = max(1, min(-(-FT._TN_BLOCKS // tiles), -(-m // 256)))
            split = up(-(-m // splits), 32)
            Kp, Np = up(K, FT._TN_TILE), up(N, FT._TN_TILE)
        else:
            split = WL.tn_split(K, N, m, FT._TN_BLOCKS_BF16)
            Kp, Np = up(K, WL.BM), up(N, WL.BN_TN)
        total += count * bound(0.0, 4 * (-(-m // split) * Kp * Np + K * N))[0]
    return total


def copy_calls(torch):
    """The copy_cols calls of a flagship bf16 step (56,448 rows), as the
    recording gives them, (m, width, src dtype, lds, ldd, src offset, dst
    offset) -> count: a 'full_nocolor' step's four (K2's e, K3's de, dfeat
    from dout[:, 1:] 4 bytes into its row, dsdf) and a 'pallas' step's two
    (K5's u, K6's de)."""
    m, f32 = TRAIN_FINE_PTS, torch.float32
    return {"full_nocolor": {(m, 1386, torch.bfloat16, 1408, 1386, 0, 0): 1,
                             (m, 1386, f32, 1386, 1792, 0, 0): 1,
                             (m, 256, f32, 257, 1792, 1, 0): 1, (m, 1, f32, 257, 1, 0, 0): 1},
            "pallas": {(m, 1386, f32, 1408, 1386, 0, 0): 2}}


def copy_readings(torch, dev, calls, timed: bool = True):
    """copy_cols_kernel at each call {(m, width, src dtype, lds, ldd, src
    offset, dst offset): count} on seeded sources laid out as the call's
    (the offsets: elements past a 16-byte boundary), into NaN-filled
    destinations: the same bits as copy_cols_plain and as torch's copy_,
    every other destination element untouched; ms beside
    dst[:, :w].copy_(src[:, :w]), the plain version and the bound (each
    source element read once, each f32 written once)."""
    from honerf_torch.ops import fused_fine as FT

    lib, stream = FT._lib(), torch.cuda.current_stream(dev).cuda_stream
    gen = torch.Generator(device=dev).manual_seed(31)
    out = []
    for (m, width, sdt, lds, ldd, so, do), count in calls.items():
        sbuf = torch.randn((m * lds + so,), generator=gen, device=dev).to(sdt)
        dbuf = torch.full((m * ldd + do,), float("nan"), device=dev)
        src, dst = sbuf[so:].view(m, lds), dbuf[do:].view(m, ldd)
        FT.copy_cols(lib, src, m, width, dst, stream)
        want = FT.copy_cols_plain(src, m, width)
        lib_dst = torch.empty((m, width), device=dev)
        lib_dst.copy_(src[:, :width])
        same = bool(torch.equal(dst[:, :width], want)) and bool(torch.equal(lib_dst, want))
        rest = bool(torch.isnan(dst[:, width:]).all()) and bool(torch.isnan(dbuf[:do]).all())
        r = SimpleNamespace(m=m, width=width, dtype=sdt, lds=lds, ldd=ldd, so=so, do=do,
                            count=count, same=same, ok=same and rest,
                            max_abs=float((dst[:, :width] - want).abs().max()) if m else 0.0)
        if timed:
            r.ms = cuda_ms(torch, lambda: FT.copy_cols(lib, src, m, width, dst, stream), 20)
            r.lib_ms = cuda_ms(torch, lambda: dst[:, :width].copy_(src[:, :width]), 20)
            r.plain_ms = cuda_ms(torch, lambda: dst[:, :width].copy_(
                FT.copy_cols_plain(src, m, width)), 20)
            r.bound_ms, r.bound_by = bound(0.0, m * width * (src.element_size() + 4))
        out.append(r)
        del sbuf, dbuf, lib_dst
    return out


def graph_ms(torch, fn, iters: int = 20, reps: int = 5) -> float:
    """Device ms a call of fn: `iters` calls captured into one CUDA graph,
    replayed `reps` times between two events, so that the host's time to
    launch a call (longer than a kernel of a few microseconds) is not what
    is read.  fn reads the current stream when called (the capture's)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    g.reset()
    return start.elapsed_time(end) / (iters * reps)


def pack_calls(torch):
    """The trunk_pack_e calls of the main path's 'pallas' runs, as the
    recording gives them, (m, E, lde, ldo, eb dtype, e's offset mod 16
    bytes in elements) -> count: a flagship bf16 step's two (K5 and K6 on
    its 56,448 fine points), an f32 step's four (each in two passes of
    28,288 and 28,160 points), a 4096-ray request's eight (K5 on 524,288
    points in passes of 65,536) and a '12' fit step's four (f32, 37,632
    points: K5 and the frozen K6 in two passes of 18,816 each).  Every
    pass starts e on a 16-byte boundary; its odd rows (5,544 bytes apart)
    start 8 bytes past one."""
    bf, f32, m = torch.bfloat16, torch.float32, TRAIN_FINE_PTS
    return {"step": {(m, 1386, 1386, 1408, bf, 0): 2},
            "f32 step": {(28288, 1386, 1386, 1408, f32, 0): 2,
                         (28160, 1386, 1386, 1408, f32, 0): 2},
            "request": {(65536, 1386, 1386, 1408, bf, 0): 8},
            "fit step": {(18816, 1386, 1386, 1408, f32, 0): 4}}


def pose_calls(torch):
    """K3's pose-sum calls, (m, acc) -> count: a flagship bf16 'full' step's
    one (56,448 rows), an f32 step's two passes (28,288 rows, then 28,160
    added) and a fit step's two (18,816 rows each)."""
    return {"step": {(TRAIN_FINE_PTS, 0): 1}, "f32 step": {(28288, 0): 1, (28160, 1): 1},
            "fit step": {(18816, 0): 1, (18816, 1): 1}}


def ragged_pack_pose_calls(torch):
    """The pack and the pose sum at sizes the main path's leave out: 1, 7
    and 70,001 rows, e starting 4, 12 and 8 bytes past a 16-byte boundary
    (bf16, f32, bf16); the pose sum at 1, 511 (acc 1) and 70,001 rows."""
    bf, f32 = torch.bfloat16, torch.float32
    return ({(1, 1386, 1386, 1408, bf, 1): 1, (7, 1386, 1386, 1408, f32, 3): 1,
             (70001, 1386, 1386, 1408, bf, 2): 1},
            {(1, 0): 1, (511, 1): 1, (70001, 0): 1})


def pack_readings(torch, dev, calls, timed: bool = True):
    """trunk_pack_e_kernel at each call {(m, E, lde, ldo, dtype, offset):
    count} on seeded normal e laid out as the call's (rows lde floats
    apart, `offset` floats past a 16-byte boundary), into a NaN-filled eb:
    the same bits as trunk_pack_e_plain and as eb[:, :E].copy_(e) into a
    zeroed eb (one PyTorch call of the same function).  timed: ms of the
    kernel and of that copy_ (CUDA graphs: graph_ms), of the plain version
    and the bound (e read once, eb written once)."""
    from honerf_torch.ops import fused_fine as FT

    lib = FT._lib()
    gen = torch.Generator(device=dev).manual_seed(37)
    out = []
    for (m, E, lde, ldo, dtype, so), count in calls.items():
        buf = torch.randn((m * lde + so,), generator=gen, device=dev)
        e = buf[so:].view(m, lde)[:, :E]
        eb = torch.full((m, ldo), float("nan"), device=dev, dtype=dtype)

        def run(e=e, m=m, eb=eb):
            FT.trunk_pack_e(lib, e, m, eb, torch.cuda.current_stream().cuda_stream)

        run()
        want = FT.trunk_pack_e_plain(e, m, ldo, dtype)
        lib_eb = torch.zeros((m, ldo), device=dev, dtype=dtype)
        lib_eb[:, :E].copy_(e)
        torch.cuda.synchronize()
        same, same_lib = bool(torch.equal(eb, want)), bool(torch.equal(lib_eb, want))
        r = SimpleNamespace(m=m, E=E, lde=lde, ldo=ldo, dtype=str(dtype).split(".")[-1], so=so,
                            count=count, same=same, same_lib=same_lib, ok=same and same_lib,
                            max_abs=float((eb.float() - want.float()).abs().max()), ms=None,
                            plain_ms=None, lib_ms=None, bound_ms=None, bound_by=None)
        if timed:
            r.ms = graph_ms(torch, run)
            r.lib_ms = graph_ms(torch, lambda lib_eb=lib_eb, e=e, E=E: lib_eb[:, :E].copy_(e))
            r.plain_ms = cuda_ms(torch, lambda e=e, m=m, ldo=ldo, dtype=dtype:
                                 FT.trunk_pack_e_plain(e, m, ldo, dtype), 5)
            r.bound_ms, r.bound_by = bound(0.0, m * (4 * E + ldo * eb.element_size()))
        del buf, e, eb, want, lib_eb
        out.append(r)
    return out


def pose_readings(torch, dev, calls, timed: bool = True):
    """pose_sum_kernel at each call {(m, acc): count} on seeded normal pose
    rows P (m, 256), onto an out of zeros (acc 0) or of seeded values (acc
    1): the same bits as pose_sum_ordered_plain on the card (the card's SM
    count), the same bits on a rerun, within TOL_COLSUM_F64 of the f64 sum.
    timed: device ms of the kernel and of P[:m].sum(0), the library
    yardstick (CUDA graphs: graph_ms; P, 58 MB at most, stays in the 50 MB
    L2 in part between the calls, as after fine_bwd_emb_kernel writes it),
    the plain version's ms and the bound (P read once, out written once)."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF

    blib = FF._bwd_lib()
    ws = torch.empty((FT._WS_FLOATS,), device=dev)
    gen = torch.Generator(device=dev).manual_seed(41)
    out = []
    for (m, acc), count in calls.items():
        P = torch.randn((m, 256), generator=gen, device=dev)
        base = (torch.randn((256,), generator=gen, device=dev) if acc
                else torch.zeros((256,), device=dev))
        res = torch.empty((256,), device=dev)

        def run(P=P, m=m, acc=acc, res=res, base=base):
            res.copy_(base)
            FF.pose_sum(blib, P, m, res, acc, ws, torch.cuda.current_stream().cuda_stream)

        run()
        got = res.clone()
        run()
        again = res.clone()
        want = FF.pose_sum_ordered_plain(P, m, base.clone(), acc)
        torch.cuda.synchronize()
        f64 = float((got.double() - (base.double() * acc + P.double().sum(0))).abs().max())
        same, rerun = bool(torch.equal(got, want)), bool(torch.equal(got, again))
        r = SimpleNamespace(m=m, acc=acc, count=count, same=same, rerun=rerun, f64=f64,
                            max_abs=float((got - want).abs().max()),
                            ok=same and rerun and f64 <= TOL_COLSUM_F64, ms=None, plain_ms=None,
                            lib_ms=None, bound_ms=None, bound_by=None)
        if timed:
            r.ms = graph_ms(torch, lambda P=P, m=m, acc=acc, res=res: FF.pose_sum(
                blib, P, m, res, acc, ws, torch.cuda.current_stream().cuda_stream))
            r.lib_ms = graph_ms(torch, lambda P=P, m=m: P[:m].sum(0))
            r.plain_ms = cuda_ms(torch, lambda P=P, m=m: FF.pose_sum_ordered_plain(P, m), 3)
            r.bound_ms, r.bound_by = bound(float(m * 256), 4 * (m * 256 + 256), PEAK_F32_FLOPS)
        del P
        out.append(r)
    return out


def log_pack_pose(label, packs, poses) -> None:
    """Log pack_readings and pose_readings of one path, each call and the
    path's weighted total."""
    for r in packs:
        log(f"PACK {label}: {r.count} x {r.m} rows ({r.dtype}, E {r.E}, lde {r.lde} +{r.so}, ldo "
            f"{r.ldo}): the same bits as trunk_pack_e_plain {r.same}, as copy_ {r.same_lib}; "
            f"kernel {r.ms:.4f} ms, eb[:, :E].copy_(e) {r.lib_ms:.4f} ms, plain "
            f"{r.plain_ms:.4f} ms, bound {r.bound_ms:.4f} ms ({r.bound_by}): "
            f"{r.bound_ms / r.ms:.2f} of the bound, {r.lib_ms / r.ms:.2f}x copy_'s speed"
            f"{'' if r.ok else ' FAIL'}")
    if packs:
        t = weighted(packs)
        log(f"trunk_pack_e_kernel, a {label}'s {sum(r.count for r in packs)} launches: kernel "
            f"{t['ms']:.4f} ms, copy_ {t['lib_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms: {t['bound_ms'] / t['ms']:.2f} of the bound, "
            f"{t['lib_ms'] / t['ms']:.2f}x copy_'s speed")
    for r in poses:
        log(f"POSE {label}: {r.count} x {r.m} rows, acc {r.acc}: the same bits as "
            f"pose_sum_ordered_plain {r.same}, on a rerun {r.rerun}, |err| vs f64 {r.f64:.2e} "
            f"(tol {TOL_COLSUM_F64:g}); kernel {r.ms:.4f} ms, P[:m].sum(0) {r.lib_ms:.4f} ms, "
            f"plain {r.plain_ms:.3f} ms, bound {r.bound_ms:.4f} ms ({r.bound_by}; L2 can beat "
            f"it): {r.bound_ms / r.ms:.2f} of the bound, {r.lib_ms / r.ms:.2f}x the torch sum's "
            f"speed{'' if r.ok else ' FAIL'}")
    if poses:
        t = weighted(poses)
        log(f"pose_sum_kernel, a {label}'s {sum(r.count for r in poses)} launches: kernel "
            f"{t['ms']:.4f} ms, P[:m].sum(0) {t['lib_ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, "
            f"bound {t['bound_ms']:.4f} ms: {t['bound_ms'] / t['ms']:.2f} of the bound, "
            f"{t['lib_ms'] / t['ms']:.2f}x the torch sum's speed")


def pack_pose_row(prefix, packs, poses, rows) -> None:
    """Put a path's pack and pose-sum readings into the kernels line's
    PACK and POSE rows under `prefix` (the bf16 step's: no prefix)."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF

    for key, kern, rs in (("PACK", FT.PACK, packs), ("POSE", FF.POSE, poses)):
        if not rs:
            continue
        t = weighted(rs)
        row = dict(rows.get(key, {}), name=kern.name, route="cuda", source=kern.source,
                   replaces=kern.replaces, bound_by="bytes")
        row.update({f"{prefix}ms": t["ms"], f"{prefix}plain_ms": t["plain_ms"],
                    f"{prefix}bound_ms": t["bound_ms"], f"{prefix}library_ms": t["lib_ms"]})
        err = max(r.max_abs for r in rs)
        row["max_abs_err"] = max(err, row.get("max_abs_err") or 0.0)
        rows[key] = row


def weighted(rs, keys=("ms", "plain_ms", "lib_ms", "bound_ms")):
    """{key: sum of r.key x r.count} over readings (keys a reading has)."""
    return {k: sum(getattr(r, k) * r.count for r in rs) for k in keys
            if all(getattr(r, k, None) is not None for r in rs)}


# Device time by kernel name of every profiled path (device_profile's
# label -> {name: [us, launches]}), for the per-point kernels' table
PROFILES = {}
PERPOINT_KERNELS = ("hand_trunk_fwd_kernel", "hand_uchain_kernel", "hand_trunk_ut_kernel",
                    "hand_trunk_dz_kernel", "hand_trunk_fwd_f32_kernel",
                    "hand_uchain_f32_kernel", "hand_trunk_ut_f32_kernel",
                    "hand_trunk_dz_f32_kernel", "trunk_dw_f32_kernel", "color_fwd_f32_kernel",
                    "color_bwd_f32_kernel", "color_fwd_kernel", "color_bwd_kernel",
                    "gemm_f32_kernel", "gemm_tn_f32_kernel", "gemm_kernel",
                    "uchain_seed_kernel", "fine_bwd_rev_kernel", "fine_rev_kernel",
                    "fine_bwd_emb_kernel", "color_dz_kernel", "pose_sum_kernel",
                    "reduce_partials_kernel", "copy_cols_kernel", "trunk_pack_e_kernel",
                    "trunk_bwd_seed_kernel", "hand_embed_kernel", "colsum_partial_kernel")
# the pose sums' kernels before their one launch (pose_sum_kernel): no
# profiled path may show them
RETIRED_KERNELS = ("pose_partial_kernel", "pose_reduce_kernel")
# the f32 weight gradients' sequence before its one launch
# (trunk_dw_f32_kernel) and the f32 color net's split launches before its
# two (color_fwd_f32_kernel, color_bwd_f32_kernel): no profiled f32 step
# may show them
RETIRED_F32_KERNELS = ("gemm_tn_f32_kernel", "reduce_partials_kernel", "colsum_partial_kernel",
                       "gemm_f32_kernel", "color_dz_kernel")
# the bf16 color net's split launches before its two (color_fwd_kernel,
# color_bwd_kernel) and the bf16 trunk backward's before its two
# (hand_trunk_ut_kernel, hand_trunk_dz_kernel): no profiled bf16 request
# or step may show gemm_kernel or color_dz_kernel; each shows the pairs'
# kernels it runs
_BWD16 = ("hand_trunk_ut_kernel", "hand_trunk_dz_kernel")
RETIRED_BF16 = {f"one request of {REQUEST_RAYS} rays": (("gemm_kernel", "color_dz_kernel"),
                                                        ("color_fwd_kernel",)),
                f"one train step of {TRAIN_RAYS} rays": (("gemm_kernel", "color_dz_kernel"),
                                                         ("color_fwd_kernel", "color_bwd_kernel")
                                                         + _BWD16),
                f"one train pallas step of {TRAIN_RAYS} rays": (("gemm_kernel",), _BWD16),
                f"one train full_nocolor step of {TRAIN_RAYS} rays": (("gemm_kernel",), _BWD16)}


def perpoint_bytes(kern: str, f32: bool):
    """Bytes a point of the flagship (E 1386, Ep 1408, d_out 257, F = Fp
    256, Gp 128, Op 320, the last color layer's 64 columns) costs the
    kernel, each input read once and each output written once, from its
    code (es: the operand type's size); None where the work
    is not per point (copy_cols_kernel, reduce_partials_kernel: the
    per-point phase bounds them call by call)."""
    es = 4 if f32 else 2
    return {
        # u (E f32), z's sdf and F features, the point; packed's 5 f32 and
        # x2 = [feat | grad-PE] (Fp + Gp of the type)
        "fine_rev_kernel": 4 * (1386 + 257 + 3) + 4 * 5 + (256 + 128) * es,
        # u, de, dx (E f32 each), dg_total, the point; dp, the pose row
        "fine_bwd_emb_kernel": 4 * (3 * 1386 + 3 + 3) + 4 * (3 + 256),
        # the sigmoid and dcolor (3 f32 each); dzf (64 f32), dzb (64)
        "color_dz_kernel": 4 * 6 + 64 * (4 + es),
        # the pose row (256 f32) read once
        "pose_sum_kernel": 4 * 256,
        # e (E f32) -> e of the type, Ep columns
        "trunk_pack_e_kernel": 4 * 1386 + 1408 * es,
        # dout (257 f32), du (E f32); dzf (Op f32), dzb (Op), du_b, du_s (Ep)
        "trunk_bwd_seed_kernel": 4 * (257 + 1386) + 320 * (4 + es) + 2 * 1408 * es,
    }.get(kern)


def log_perpoint_profiles() -> list:
    """Each per-point kernel's launches and device ms in each profiled path
    (PROFILES), summed over its template instances, and, where its work is
    per point, its bound there: launches x the path's points a launch x
    perpoint_bytes at PEAK_BYTES.  Returns what is wrong: a retired kernel
    (RETIRED_KERNELS) in a profile, the f32 dW sequence (RETIRED_F32_KERNELS)
    in an f32 step's or a fit step's, pose_sum_kernel in none, or the bf16
    color net's split launches in a bf16 request's or step's profile
    (RETIRED_BF16) or its pair missing there."""
    for kern in PERPOINT_KERNELS:
        parts = []
        for label, (groups, points) in PROFILES.items():
            hits = [(name, v) for name, v in groups.items() if kern in name]
            if not hits:
                continue
            n, us = sum(v[1] for _, v in hits), sum(v[0] for _, v in hits)
            text = f"{label}: {n} x, {us / 1e3:.4f} ms"
            per = perpoint_bytes(kern, any("<float>" in name for name, _ in hits))
            if per and points:
                b_ms = n * points * per / PEAK_BYTES * 1e3
                text += f", bound {b_ms:.4f} ms ({per} B/pt x {points} pts a launch)"
            parts.append(text)
        log(f"profiled {kern}: " + ("; ".join(parts) if parts else "in no profiled path"))
    wrong = [f"{kern} in {label}" for label, (groups, _) in PROFILES.items()
             for kern in RETIRED_KERNELS if any(kern in name for name in groups)]
    wrong += [f"{kern} in {label}" for label, (groups, _) in PROFILES.items()
              if "f32" in label or "fit step" in label
              for kern in RETIRED_F32_KERNELS if any(kern in name for name in groups)]
    if not any("pose_sum_kernel" in name for groups, _ in PROFILES.values() for name in groups):
        wrong.append("pose_sum_kernel in no profile")
    for label, (gone, shown) in RETIRED_BF16.items():
        groups = PROFILES.get(label, ({}, None))[0]
        wrong += [f"{kern} in {label}" for kern in gone if any(kern in n for n in groups)]
        wrong += [f"{kern} not in {label}" for kern in shown if not any(kern in n for n in groups)]
    return wrong


# -- the flagship and its train step (check_k3_faults.py runs these too) --

def flagship(torch, dev, trunk_dtype: str = "bf16") -> SimpleNamespace:
    """The flagship conf with bf16 trunks (as bench.py sets it; "f32": the
    conf's own trunks, as written) and its random weights on dev: conf,
    sdf, color (the nets' configs), rcfg, tcfg, params."""
    from honerf_torch.config import load_config
    from honerf_torch.models.fields import (
        color_config_from_conf,
        init_color_params,
        init_sdf_params,
        init_variance_params,
        sdf_config_from_conf,
    )
    from honerf_torch.render.neus import RenderConfig
    from honerf_torch.train.offline import TrainHyper

    conf = load_config(CONF)
    sdf_cfg = sdf_config_from_conf("hand", conf["model.sdf_network"])._replace(
        trunk_dtype=trunk_dtype)
    color_cfg = color_config_from_conf("hand", conf["model.rendering_network"])._replace(
        trunk_dtype=trunk_dtype)
    gen = torch.Generator().manual_seed(0)
    params = {
        "sdf": perturb(torch, init_sdf_params(gen, sdf_cfg, device=dev), gen),
        "color": perturb(torch, init_color_params(gen, color_cfg, device=dev), gen),
        "variance": init_variance_params(
            float(conf.get("model.variance_network.init_val", 0.3)), device=dev),
    }
    return SimpleNamespace(conf=conf, sdf=sdf_cfg, color=color_cfg,
                           rcfg=RenderConfig.from_conf(conf["model.neus_renderer"]),
                           tcfg=TrainHyper.from_conf(conf), params=params)


def train_hyper(fs):
    """The train phases' hyperparameters: the conf's, with TRAIN_RAYS rays,
    vgg_weight 0 and refine_pose on."""
    return fs.tcfg._replace(batch_size=TRAIN_RAYS, vgg_weight=0.0, refine_pose=True)


def train_batch(torch, n_rays: int, device, seed: int = 0):
    """The batch bench.py builds: seeded rays, colors and mask, the posed
    example's camera and joints, T-pose bone lengths."""
    import numpy as np

    from honerf_torch.data.datasets import get_bone_length
    from honerf_torch.data.synthetic import canonical_hand_joints, posed_hand_example

    joints, cam_R, cam_T = posed_hand_example()
    t_pose = canonical_hand_joints(0.0)
    rng = np.random.default_rng(seed)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return dict(rays_xy=f(rng.uniform(-0.5, 0.5, (n_rays, 2))),
                true_rgb=f(rng.uniform(0, 1, (n_rays, 3))),
                true_mask=f(rng.uniform(0, 1, (n_rays, 1)) > 0.4),
                focal=f([3.0, 3.0]), principal=f(np.zeros(2)), index=0,
                cam_R=f(cam_R), cam_T=f(cam_T), joints=f(joints), t_pose_21=f(t_pose),
                bone_length=f(get_bone_length(t_pose)))


def train_params(fs, device):
    """A copy of the flagship's weights on device, with se3_refine."""
    from honerf_torch.models.fields import init_se3_refine

    return dict(clone_tree(fs.params, device),
                se3_refine=init_se3_refine(8, "hand", device=device))


def k3_outputs(grads):
    """[(name, tensor)] of every output of K3 (with or without the color
    net)."""
    outs = [("dp", grads.dp), ("drotT", grads.drotT), ("doff", grads.doff)]
    for field in ("dws", "dbs", "dcws", "dcbs"):
        outs += [(f"{field}[{l}]", x) for l, x in enumerate(getattr(grads, field) or ())]
    return outs


def k6_outputs(res):
    """[(name, tensor)] of every output of K6: (de, dws, dbs)."""
    de, dws, dbs = res
    return ([("de", de)] + [(f"dws[{l}]", x) for l, x in enumerate(dws or ())]
            + [(f"dbs[{l}]", x) for l, x in enumerate(dbs or ())])


def bwd_entry(mode: str):
    """(module, kernel entry, plain version, outputs, number of leading
    non-cotangent arguments) of the backward that a train step in the
    fine-pass mode runs: K3 ('full'), K3 without the color net
    ('full_nocolor'), K6 ('pallas')."""
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF

    if mode == "pallas":
        return FT, "hand_trunk_sdf_u_bwd", FT.hand_trunk_sdf_u_plain_bwd, k6_outputs, 2
    return FF, "hand_fine_color_bwd", FF.hand_fine_color_plain_bwd, k3_outputs, 5


def step_bwd_inputs(torch, fs, dev, seed: int = 0, mode: str = "full"):
    """What one flagship train step in the fine-pass mode (batch and
    jitter from `seed`) hands its backward kernel: for 'full' (K3) its fine
    samples, the refined pose, the pack and the loss's cotangents on (sdf,
    g, color); for 'full_nocolor' the same with cotangents on (out, g, e);
    for 'pallas' (K6) the embedding, the pack and the cotangents on (out,
    u)."""
    from honerf_torch.train.offline import init_train_state, make_hand_train_step

    mod, name, _, _, _ = bwd_entry(mode)
    ttcfg = train_hyper(fs)._replace(fused_fine=mode)
    seen = []
    wrapped = getattr(mod, name)
    setattr(mod, name, lambda *a, **k: seen.append(a) or wrapped(*a, **k))
    try:
        state = init_train_state(train_params(fs, dev), ttcfg)
        step = make_hand_train_step(fs.sdf, fs.color, fs.rcfg, ttcfg)
        step(state, train_batch(torch, TRAIN_RAYS, dev, seed),
             torch.Generator(device=dev).manual_seed(seed))
    finally:
        setattr(mod, name, wrapped)
    return tuple(a.detach() if torch.is_tensor(a) else a for a in seen[0][:-1])  # not want_dw


def cpu_pack(pack):
    """A kernel pack's weights on the CPU (no transposed copies)."""
    fields = {f: tuple(t.cpu() for t in getattr(pack, f))
              for f in ("ws", "bs", "cws", "cbs") if f in pack._fields}
    fields.update({f: None for f in ("wts", "cwts") if f in pack._fields})
    return pack._replace(**fields)


def k3_check(torch, args, mode: str = "full"):
    """The mode's backward kernel (K3 by default; K6, the no-color K3)
    against its plain version on the card on the same inputs: the kernel's
    outputs, and per output a namespace of what, l2 (|got - want| / |want|
    in L2), med, mx (median and max of |got - want| over the range),
    max_abs, ok (finite and l2 <= TOL_K3_L2) and text."""
    mod, name, plain, outputs, _ = bwd_entry(mode)
    got = getattr(mod, name)(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    rows = []
    for (what, a), (_, b) in zip(outputs(got), outputs(want)):
        med, _, mx, scale = err_readings(torch, a, b)
        l2 = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        ok = bool(torch.isfinite(a).all()) and l2 <= TOL_K3_L2
        rows.append(SimpleNamespace(
            what=what, l2=l2, med=med / scale, mx=mx / scale, max_abs=mx, ok=ok,
            text=(f"{what}: |err| L2 {l2:.2e} of |plain| (tol {TOL_K3_L2:g}); median "
                  f"{med / scale:.2e}, max {mx / scale:.2e} of the range {scale:.3e}"
                  f"{'' if ok else ' FAIL'}")))
    return got, rows


def k3_unit_check(torch, args, seed: int = 3, mode: str = "full"):
    """The mode's backward kernel (K3 by default) on seeded unit
    cotangents at the inputs of args, against its plain version on the
    card, with the plain version on the CPU as the floor: per output a
    namespace of what, err (|kernel - plain|), floor (|plain - plain on the
    CPU|), norm (|plain|), ratio (err / (K3_FACTOR floor + K3_REL norm)),
    all in L2, ok (finite and ratio <= 1) and text."""
    mod, name, plain, outputs, lead = bwd_entry(mode)
    dev = args[0].device
    gen = torch.Generator(device=dev).manual_seed(seed)
    args = args[:lead] + tuple(torch.randn(c.shape, generator=gen, device=dev)
                               for c in args[lead:])
    cpu_args = [cpu_pack(a) if hasattr(a, "_fields") else a.cpu() for a in args]
    res = [getattr(mod, name)(*args), plain(*args), plain(*cpu_args)]
    rows = []
    for (what, a), (_, b), (_, c) in zip(*(outputs(r) for r in res)):
        err, floor, norm = (float(x.norm()) for x in (a - b, c.to(dev) - b, b))
        ratio = err / (K3_FACTOR * floor + K3_REL * norm + 1e-30)
        ok = bool(torch.isfinite(a).all()) and ratio <= 1.0
        rows.append(SimpleNamespace(
            what=what, err=err, floor=floor, norm=norm, ratio=ratio, ok=ok,
            text=(f"{what}: |kernel - plain| {err:.3e}, |plain - plain on the CPU| {floor:.3e}, "
                  f"|plain| {norm:.3e}: {ratio:.3f} of the limit"
                  f"{'' if ok else ' FAIL'}")))
    return rows


def f32_bwd_check(torch, args, mode: str = "full", want_dw: bool = True, seed=None,
                  shared_g: bool = True):
    """The mode's backward kernel with an f32 trunk (K3, its no-color mode,
    K6) against its plain version on the card on the same inputs, or with
    `seed` on seeded unit cotangents at those inputs: per output a
    namespace of what, l2 (|got - want| / |want| in L2), max_abs, ok
    (finite and l2 <= TOL_F32) and text.  With the color net and shared_g
    the plain version reads the kernel's g and dcolor is zero within
    FF.RELU_MARGIN of a relu kink (FF.shared_g_cotangents; the f32 rule's
    note above TOL_TRAIN_F32_LOSS).  Returns (the kernel's outputs, the rows, the points whose
    dcolor was zeroed)."""
    from honerf_torch.ops import fused_fine_full as FF

    mod, name, plain, outputs, lead = bwd_entry(mode)
    if seed is not None:
        gen = torch.Generator(device=args[0].device).manual_seed(seed)
        args = tuple(args[:lead]) + tuple(torch.randn(c.shape, generator=gen, device=c.device)
                                          for c in args[lead:])
    kw, dropped = {}, 0
    if mode == "full" and shared_g:
        g, cts, dropped = FF.shared_g_cotangents(*args)
        args, kw = tuple(args[:5]) + cts, dict(g_color=g)
    got = getattr(mod, name)(*args, want_dw=want_dw)
    want = plain(*args, want_dw=want_dw, **kw)
    torch.cuda.synchronize()
    rows = []
    for (what, a), (_, b) in zip(outputs(got), outputs(want)):
        l2 = float((a - b).norm()) / max(float(b.norm()), 1e-30)
        ok = bool(torch.isfinite(a).all()) and l2 <= TOL_F32
        rows.append(SimpleNamespace(
            what=what, l2=l2, max_abs=float((a - b).abs().max()), ok=ok,
            text=(f"{what}: |err| L2 {l2:.2e} of |plain| {float(b.norm()):.3e} (tol "
                  f"{TOL_F32:g}){'' if ok else ' FAIL'}")))
    return got, rows, dropped


def train_check_readings(torch, fs, dev, seed: int = 1, mode: str = "full"):
    """One step of CHECK_TRAIN_RAYS rays, perturb 0, in the fine-pass mode,
    from the same state on the card and on the CPU (plain versions): the
    metrics of each, each gradient leaf's |card - cpu| / |cpu| (L2, before
    the clip), the worst loss term's relative error, and each side's
    seconds."""
    from honerf_torch.train.offline import (
        init_train_state,
        make_hand_train_step,
        resolve_grad_clip,
    )

    cpu = torch.device("cpu")
    ttcfg = train_hyper(fs)._replace(fused_fine=mode)
    rcfg_check = fs.rcfg._replace(perturb=0.0)
    res, secs = {}, {}
    for d in (dev, cpu):
        p = train_params(fs, d)
        state = init_train_state(p, ttcfg)
        step = make_hand_train_step(fs.sdf, fs.color, rcfg_check, ttcfg)
        t0 = time.perf_counter()
        state, m = step(state, train_batch(torch, CHECK_TRAIN_RAYS, d, seed=seed))
        gn = float(m["grad_norm"])
        secs[d.type] = time.perf_counter() - t0
        clip = resolve_grad_clip(ttcfg, fs.sdf)  # undo the clip
        scale = min(1.0, clip / max(gn, 1e-12)) if clip > 0 else 1.0
        res[d.type] = ({k: float(v) for k, v in m.items()},
                       [x.grad.detach().cpu() / scale for x in tree_leaves(p)])
    (mc, gc), (mp, gp) = res["cuda"], res["cpu"]
    rel = [float((a - b).norm() / max(float(b.norm()), 1e-12)) for a, b in zip(gc, gp)]
    worst_metric = max(abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-6)
                       for k in ("loss", "color_loss", "mask_loss", "eikonal_loss"))
    return SimpleNamespace(card=mc, cpu=mp, rel=rel, worst_metric=worst_metric, secs=secs)


# -- the object model (phases 10-13) --

def obj_flagship(torch, dev) -> SimpleNamespace:
    """The object conf as written (f32 trunks) and its random weights on
    dev (geometric init plus the seeded 5% noise)."""
    from honerf_torch.config import load_config
    from honerf_torch.models.fields import (
        color_config_from_conf,
        init_color_params,
        init_sdf_params,
        init_variance_params,
        sdf_config_from_conf,
    )
    from honerf_torch.render.neus import RenderConfig
    from honerf_torch.train.offline import TrainHyper

    conf = load_config(OBJ_CONF)
    sdf_cfg = sdf_config_from_conf("obj", conf["model.sdf_network"])
    color_cfg = color_config_from_conf("obj", conf["model.rendering_network"])
    gen = torch.Generator().manual_seed(0)
    params = {
        "sdf": perturb(torch, init_sdf_params(gen, sdf_cfg, device=dev), gen),
        "color": perturb(torch, init_color_params(gen, color_cfg, device=dev), gen),
        "variance": init_variance_params(float(conf["model.variance_network"]["init_val"]),
                                         device=dev),
    }
    return SimpleNamespace(conf=conf, sdf=sdf_cfg, color=color_cfg,
                           rcfg=RenderConfig.from_conf(conf["model.neus_renderer"]),
                           tcfg=TrainHyper.from_conf(conf), params=params)


def obj_train_batch(torch, n_rays: int, device, seed: int = 0):
    """The object batch bench.py builds: seeded rays, colors and mask, a
    look-at camera at the object, the identity object pose."""
    import numpy as np

    from honerf_torch.data.synthetic import look_at_camera

    rng = np.random.default_rng(seed)
    R, T = look_at_camera(np.asarray([0.0, 0.2, -0.9]), np.zeros(3))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return dict(rays_xy=f(rng.uniform(-0.5, 0.5, (n_rays, 2))),
                true_rgb=f(rng.uniform(0, 1, (n_rays, 3))),
                true_mask=f(rng.uniform(0, 1, (n_rays, 1)) > 0.4),
                focal=f([3.0, 3.0]), principal=f(np.zeros(2)), index=0,
                cam_R=f(R), cam_T=f(T), Ro=f(np.eye(3)), To=f(np.zeros(3)))


def read_png(path: str):
    """(H, W, 3) uint8 of an 8-bit RGB PNG without filters (the runner's
    own writer), with zlib and struct only."""
    import struct
    import zlib

    import numpy as np

    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    off, idat, (W, H) = 8, b"", (0, 0)
    while off < len(data):
        (n,) = struct.unpack(">I", data[off:off + 4])
        kind, body = data[off + 4:off + 8], data[off + 8:off + 8 + n]
        if kind == b"IHDR":
            W, H = struct.unpack(">II", body[:8])
        elif kind == b"IDAT":
            idat += body
        off += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(H, 1 + 3 * W)
    assert not rows[:, 0].any(), "filtered rows"
    return rows[:, 1:].reshape(H, W, 3)


# -- pose fitting (phases 29-35) --

def fit_nets(torch, dev):
    """The fit confs' nets (fit_confs/fit_1_8views.conf: f32 trunks) with
    random weights on dev (geometric init plus the seeded 5% noise): conf,
    hand_sdf, hand_color, obj_sdf, obj_color, rcfg, nets."""
    from honerf_torch.config import load_config
    from honerf_torch.models.fields import (
        color_config_from_conf,
        init_color_params,
        init_sdf_params,
        init_variance_params,
        sdf_config_from_conf,
    )
    from honerf_torch.render.neus import RenderConfig

    conf = load_config(FIT_CONFS["1"])
    out = SimpleNamespace(conf=conf, rcfg=RenderConfig.from_conf(conf["model.neus_renderer"]),
                          nets={})
    gen = torch.Generator().manual_seed(0)
    for kind in ("hand", "obj"):
        sdf = sdf_config_from_conf(kind, conf[f"model.sdf_{kind}_network"])
        color = color_config_from_conf(kind, conf[f"model.rendering_{kind}_network"])
        setattr(out, f"{kind}_sdf", sdf)
        setattr(out, f"{kind}_color", color)
        out.nets[kind] = {
            "sdf": perturb(torch, init_sdf_params(gen, sdf, device=dev), gen),
            "color": perturb(torch, init_color_params(gen, color, device=dev), gen),
            "variance": init_variance_params(float(conf["model.variance_network"]["init_val"]),
                                             device=dev)}
    hand_surface(torch, out.nets["hand"]["sdf"], out.hand_sdf, dev)
    return out


def hand_surface(torch, sdf_params, cfg, dev) -> None:
    """Bring the random hand field near its zero level: the sdf row's
    sign flipped and shifted so the field is +0.2 half a metre from the
    hand (0.14-0.28 at a fit step's fine samples).  As initialised it
    sits at 0.75-0.90 there, where the ladder's weights are on their
    floor, so its samples, and K1's flips, move nothing.  (The parity
    tests' -5 gain, tests/test_torch_parity.py::net_params, gives the
    full-width field |g| ~ 350 and a fit step an ill-conditioned
    gradient: 1 ulp on the points moves K3's dp by 3%.)"""
    from honerf_torch.data.synthetic import canonical_hand_joints, posed_hand_example
    from honerf_torch.hand import bone_transforms_from_mano_joints
    from honerf_torch.models.fields import sdf_hand_apply

    joints = torch.as_tensor(posed_hand_example()[0], device=dev)
    bt = bone_transforms_from_mano_joints(joints[None])[0]
    last = sdf_params["layers"][-1]
    with torch.no_grad():
        last["g"][0] *= -1.0
        p = (joints.mean(0) + torch.tensor([0.0, 0.0, 0.5], device=dev))[None]
        far = sdf_hand_apply(sdf_params, cfg, p, bt,
                             torch.as_tensor(canonical_hand_joints(0.0), device=dev))[0][0, 0]
        last["b"][0] -= far - 0.2


def fit_workspace(torch, fn, dev, ws: str):
    """A fitting workspace in ws: the port's synthetic catch sequence (1
    frame, 8 views, the confs' 230x266), the nets of fit_nets written as
    offline checkpoints in the JAX runner's npz layout, and the two fit
    confs pointed at ws with train.iter_num = FIT_ITERS.  Returns the
    confs' paths and the sequence's seconds."""
    from honerf_torch.data.synthetic import generate_catch_sequence
    from honerf_torch.train.checkpoints import save_checkpoint

    H, W = fn.conf.get_list("dataset.image_size")
    data = os.path.join(ws, "data", "catch_sequence", "test")
    t0 = time.perf_counter()
    generate_catch_sequence(data, n_frames=1, n_views=8, H=H, W=W)
    gen_s = time.perf_counter() - t0
    for kind, path in (("hand", "person1/wmask_realhand"), ("obj", "bean/wmask_realobj")):
        save_checkpoint(os.path.join(ws, "exp", path, "checkpoints", "ckpt_000000.npz"),
                        {"params": clone_tree(fn.nets[kind], torch.device("cpu"))})
    confs = {}
    for ft, src in FIT_CONFS.items():
        with open(src) as f:
            text = f.read()
        text = text.replace('save_dir = "./fit_res/CASE_NAME/wmask"',
                            f'save_dir = "{ws}/fit_res/CASE_NAME/wmask"\n'
                            f'  fit_res_root = "{ws}/fit_res"\n  exp_root = "{ws}/exp"')
        text = text.replace('fitdata_dir = "./data/catch_sequence/test"',
                            f'fitdata_dir = "{data}"')
        text = text.replace("batch_size = 196", f"batch_size = 196\n  iter_num = {FIT_ITERS}")
        confs[ft] = os.path.join(ws, f"fit_{ft}.conf")
        with open(confs[ft], "w") as f:
            f.write(text)
    return confs, gen_s


def fit_step_inputs(torch, fn, dev, fit_type: str = "1", seed: int = 0, mode: str = "full"):
    """What one fit step on the card in the fine-pass mode (fit_nets, K1,
    a seeded batch of the conf's 196 rays through the posed example hand)
    hands its frozen backward kernel: for 'full' (K3) (pts, rotT, off,
    cut, pack, dsdf, dg, dcolor); for 'full_nocolor' the same with
    cotangents on (out, g, e); for 'pallas' (K6) (e, pack, dout, du)."""
    from honerf_torch.fit.single import (
        FitHyper,
        init_fit_state,
        make_single_fit_step,
        select_fit_kernels,
    )

    mod, name, _, _, _ = bwd_entry(mode)
    fcfg = FitHyper.from_conf(fn.conf)._replace(fit_type=fit_type)
    fused, fine = select_fit_kernels(None, mode, fn.hand_sdf, dev)
    step = make_single_fit_step(fn.nets, fn.hand_sdf, fn.hand_color, fn.obj_sdf, fn.obj_color,
                                fn.rcfg, fcfg, fused_ladder=fused, fused_fine=fine)
    seen = []
    wrapped = getattr(mod, name)
    setattr(mod, name, lambda *a, **k: seen.append(a) or wrapped(*a, **k))
    try:
        step(init_fit_state(dev), fit_batch(torch, fcfg.batch_size, dev, seed),
             torch.Generator(device=dev).manual_seed(seed))
    finally:
        setattr(mod, name, wrapped)
    return tuple(a.detach() if torch.is_tensor(a) else a for a in seen[0][:-1])  # not want_dw


def fit_batch(torch, n_rays: int, device, seed: int = 0):
    """A fit batch: seeded rays, colors and mask, the posed example's
    camera, its joints with seeded noise as the initial estimate, the
    object 6 cm in front of the hand with a noisy estimate, a sphere's
    vertices, T-pose bone lengths."""
    import numpy as np

    from honerf_torch.data.datasets import get_bone_length
    from honerf_torch.data.synthetic import canonical_hand_joints, icosphere, posed_hand_example

    joints, cam_R, cam_T = posed_hand_example()
    t_pose = canonical_hand_joints(0.0)
    rng = np.random.default_rng(seed)
    To = joints.mean(0) + np.asarray([0.0, -0.02, 0.06])
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return dict(rays_xy=f(rng.uniform(-0.5, 0.5, (n_rays, 2))),
                true_rgb=f(rng.uniform(0, 1, (n_rays, 3))),
                true_mask=f(rng.uniform(0, 1, (n_rays, 1)) > 0.4),
                focal=f([3.0, 3.0]), principal=f(np.zeros(2)), cam_R=f(cam_R), cam_T=f(cam_T),
                joints_pred=f(joints + rng.normal(0, 0.003, joints.shape)),
                bone_length=f(get_bone_length(t_pose)), t_pose_21=f(t_pose),
                Ro_pred=f(np.eye(3)), To_pred=f(To + rng.normal(0, 0.004, 3)),
                obj_verts=f(icosphere(0.1)[0]), gt_joint3d=f(joints), Ro_gt=f(np.eye(3)),
                To_gt=f(To))


def fit_grid_batch(torch, n_rays: int, device, seed: int = 0):
    """fit_batch with rays that meet the hand head on: a look-at camera
    0.9 m in front of the posed example hand's centre (0.2 m above it),
    a square grid of n_rays rays over +-0.1 of the image plane (the
    parity tests' fixture, tests/torch_fit_common.py::frame, at the
    examples' pose)."""
    import numpy as np

    from honerf_torch.data.synthetic import look_at_camera, posed_hand_example

    batch = fit_batch(torch, n_rays, device, seed)
    joints = posed_hand_example()[0]
    center = joints.mean(0)
    R, T = look_at_camera(np.asarray(center + [0.0, 0.2, -0.9]), center)
    side = int(round(n_rays ** 0.5))
    g = np.linspace(-0.1, 0.1, side, dtype=np.float32)
    xy = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)[:n_rays]
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    return dict(batch, rays_xy=f(xy), cam_R=f(R), cam_T=f(T))


def fit_check_readings(torch, fn, dev, fused_ladder: bool, seed: int = 2, mode: str = "full",
                       batch_fn=None, terms: bool = False):
    """One '12' step of FIT_CHECK_RAYS rays, perturb 0, in the fine-pass
    mode ('full': K2 / the frozen K3 on the card, their plain versions on
    the CPU; 'full_nocolor', 'pallas'), from the same seeded pose near the
    start on the card and on the CPU: its loss (fit.single's
    make_single_fit_loss) and the loss's gradient in the six pose tensors;
    with `terms` each render term's (color, mask: FIT_RENDER_TERMS) on its
    own too.

    Each side places its own ladder samples (K1 on the card with
    fused_ladder, its plain version on the CPU) and then renders at the
    card's.  A third side, the CPU's step in f64 (the autograd field, its
    ladder in torch: the plain versions compute in f32), is the
    reference: f32 rounding alone moves the hand's pose gradient by
    3-5% on fit_batch's rays (the CPU's f32 step against its f64 one), so
    the card is held to the CPU's own f32 distance from f64.  At the start
    itself the refined root joint and the object's vertices equal their
    estimates up to rounding (pose_l2's d / |d| is then rounding noise),
    so the pose starts 0.02 (seeded) away.  batch_fn: the batch
    (fit_batch by default).

    Returns each side's metrics; per loss term and pose gradient (L2) the
    card's and the CPU's distance from the f64 step and the card's from
    the CPU's f32 step, and with
    `terms` per render term the same three for its gradient in the hand's
    pose (the four hand tensors in one: render_card, render_cpu,
    render_card_cpu, {term: distance}, else empty); the median and largest
    distance between the two ladders' samples; and with K1 the
    err_readings of the card's first K1 call against K1's plain version at
    its points."""
    import numpy as np

    from honerf_torch.fit.single import (
        POSE_KEYS,
        FitHyper,
        init_pose_params,
        make_single_fit_loss,
    )
    from honerf_torch.render import dual as RD

    cpu = torch.device("cpu")
    fcfg = FitHyper.from_conf(fn.conf)._replace(fit_type="12", batch_size=FIT_CHECK_RAYS)
    rcfg = fn.rcfg._replace(perturb=0.0)
    ladder = RD.dual_hierarchical_z_vals
    union = {}
    sides = [("card", dev, torch.float32, mode), ("cpu", cpu, torch.float32, mode),
             ("f64", cpu, torch.float64, None)]

    def keep(side, dtype):
        def z_vals(*args):
            union[side] = ladder(*args)
            if side != "card":
                return union["card"].to(cpu, dtype)
            return union[side]
        return z_vals

    def cast(tree, d, dtype):
        if isinstance(tree, dict):
            return {k: cast(v, d, dtype) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, d, dtype) for v in tree]
        return tree.detach().to(d, dtype).clone() if tree.is_floating_point() else tree.to(d)

    def grads(y, leaves):
        gs = torch.autograd.grad(y, leaves, allow_unused=True)
        return [torch.zeros(x.shape, dtype=torch.float64) if g is None
                else g.detach().double().cpu() for g, x in zip(gs, leaves)]

    res, k1_calls = {}, []
    from honerf_torch.ops import fused_hand as FH

    k1 = FH.fused_hand_sdf
    FH.fused_hand_sdf = lambda *a: k1_calls.append(a) or k1(*a)
    try:
        for side, d, dtype, fine in sides:
            RD.dual_hierarchical_z_vals = keep(side, dtype)
            # the f64 side: the autograd field, and its own ladder in torch
            loss_fn = make_single_fit_loss(cast(fn.nets, d, dtype), fn.hand_sdf, fn.hand_color,
                                           fn.obj_sdf, fn.obj_color, rcfg, fcfg,
                                           fused_ladder=fused_ladder and side != "f64",
                                           fused_fine=fine)
            rng = np.random.default_rng(seed)
            pose = {k: (p.detach() + torch.as_tensor(0.02 * rng.normal(size=tuple(p.shape)),
                                                    device=d)).to(dtype).requires_grad_(True)
                    for k, p in init_pose_params(d).items()}
            leaves = [pose[k] for k in POSE_KEYS]
            batch = cast((batch_fn or fit_batch)(torch, FIT_CHECK_RAYS, d, seed), d, dtype)
            _, m = loss_fn(pose, batch)
            res[side] = ({k: float(v.detach()) for k, v in m.items()},
                         grads(m["loss"], leaves), {})
            # each render term's on its own: a forward each (the fine pass's
            # backward frees what it kept)
            for t in FIT_RENDER_TERMS if terms else ():
                res[side][2][t] = grads(loss_fn(pose, batch)[0][t], leaves)
    finally:
        RD.dual_hierarchical_z_vals = ladder
        FH.fused_hand_sdf = k1
    ref = res["f64"]
    # with K1: the card's first K1 call of the step (the coarse pass at its
    # ladder's points) against K1's plain version there
    k1_rd = None
    if fused_ladder:
        a = next(c for c in k1_calls if c[0].device.type == dev.type)
        k1_rd = err_readings(torch, FH.fused_hand_sdf(*a), FH.fused_hand_sdf_plain(*a))

    def rel(g, want):
        return [float((a - b).norm() / max(float(b.norm()), 1e-12)) for a, b in zip(g, want)]

    def dist(side, ref):
        m, g, _ = res[side]
        loss = {k: abs(m[k] - ref[0][k]) / max(abs(ref[0][k]), 1e-6) for k in ref[0]}
        return loss, rel(g, ref[1])

    hand = [i for i, k in enumerate(POSE_KEYS) if not k.startswith("obj")]

    def render_dist(side, ref):
        def cat(gs):
            return [torch.cat([gs[i].flatten() for i in hand])]
        return {t: rel(cat(res[side][2][t]), cat(ref[2][t]))[0] for t in res[side][2]}

    dz = (union["card"].cpu().double() - union["cpu"].double()).abs()
    return SimpleNamespace(metrics={k: v[0] for k, v in res.items()}, card=dist("card", ref),
                           cpu=dist("cpu", ref),
                           card_cpu=dist("card", res["cpu"]), keys=POSE_KEYS,
                           render_card=render_dist("card", ref),
                           render_cpu=render_dist("cpu", ref),
                           render_card_cpu=render_dist("card", res["cpu"]),
                           ladder_dz=float(dz.max()), ladder_median=float(dz.median()),
                           k1=k1_rd)


def fit_f64_ratios(r):
    """A fit check's readings (fit_check_readings, with its f64 side)
    under the f64 rule: each loss term's and pose gradient's distance from
    the f64 step over FIT_FACTOR x the CPU's own + TOL_FIT_F32 (held at
    most 1)."""
    (c_loss, c_grad), (p_loss, p_grad) = r.card, r.cpu
    return ([c_loss[k] / (FIT_FACTOR * p_loss[k] + TOL_FIT_F32) for k in c_loss]
            + [c / (FIT_FACTOR * p + TOL_FIT_F32) for c, p in zip(c_grad, p_grad)])


def fit_render_ratios(r):
    """{render term: its hand-pose gradient's distance from the f64 step
    over FIT_FACTOR x the CPU's own + TOL_FIT_F32} of a fit check read
    with terms."""
    return {t: r.render_card[t] / (FIT_FACTOR * r.render_cpu[t] + TOL_FIT_F32)
            for t in r.render_card}


def run_fit_phases(torch, dev, phase, rows, failures) -> None:
    """Phases 29-35, pose fitting: K2 in f32 and the frozen K3 in f32, then
    the no-color K2 / K3 and K5 / K6 in f32, against their plain versions
    at a fit step's inputs, the fitting CLI
    ('1' then '12', then '12' in the other fine-pass modes) with its
    launch counts and ms per step, one step on the card against the CPU,
    and a profile of one step.  `phase` runs
    one phase and records its failure; `rows` collects the kernels
    line's numbers."""
    import numpy as np

    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF
    from honerf_torch.ops import fused_hand as FH

    fn = fit_nets(torch, dev)
    log(f"fit confs {', '.join(os.path.relpath(c, ROOT) for c in FIT_CONFS.values())}: hand "
        f"sdf {fn.hand_sdf.n_layers}x{fn.hand_sdf.d_hidden} embedding "
        f"{fn.hand_sdf.input_width} d_out {fn.hand_sdf.d_out}, color "
        f"{fn.hand_color.n_layers}x{fn.hand_color.d_hidden}; obj sdf "
        f"{fn.obj_sdf.n_layers}x{fn.obj_sdf.d_hidden} embedding {fn.obj_sdf.input_width}; "
        f"trunks {fn.hand_sdf.trunk_dtype}; render {fn.rcfg.n_samples}+{fn.rcfg.n_importance} "
        f"up {fn.rcfg.up_sample_steps}")
    f32_inputs = {}

    def fit_inputs():
        if "args" not in f32_inputs:
            f32_inputs["args"] = fit_step_inputs(torch, fn, dev)
        return f32_inputs["args"]

    def kernel_k2_f32():
        """K2 in f32 at one fit step's fine points (196 rays x 192 samples),
        TF32 off on both sides; the plain version again with TF32 on."""
        args = fit_inputs()
        pts, pack = args[0], args[4]
        n = pts.shape[0]
        fargs = args[:5]
        got = FF.hand_fine_color_fwd(*fargs)
        f32_inputs["fwd_calls"] = record_perpoint_calls(lambda: FF.hand_fine_color_fwd(*fargs))
        want = FF.hand_fine_color_plain(*fargs)
        torch.cuda.synchronize()
        checks = [compare(torch, what, a, b, TOL_F32, TOL_F32)
                  for what, a, b in zip(("sdf", "g", "color"), got, want)]
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = FF.hand_fine_color_plain(*fargs)
            torch.cuda.synchronize()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        tf32_rd = [err_readings(torch, a, b) for a, b in zip(tf32, want)]
        ms = cuda_ms(torch, lambda: FF.hand_fine_color_fwd(*fargs), 5)
        plain_ms = cuda_ms(torch, lambda: FF.hand_fine_color_plain(*fargs), 2)
        n_bytes = (nbytes([pts, *args[1:4], *pack.ws, *pack.bs, *pack.cws, *pack.cbs]) + 28 * n)
        flops = k2_flops(fn.hand_sdf, fn.hand_color, n)
        b_ms, b_by = bound(flops, n_bytes, PEAK_F32_3XTF32_FLOPS)
        log(f"K2 f32 hand_fine_color_fwd: {n} pts "
            f"({-(-n // FF.chunk_size(n, 'f32', FF.CHUNK))} passes); "
            f"{'; '.join(c[2] for c in checks)}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}, {flops / 1e12:.4f} TFLOP, {flops / n / 1e6:.3f} "
            f"MFLOP/pt, {flops / ms / 1e9:.1f} TFLOP/s)")
        log("K2 f32: the plain version with TF32 on, against TF32 off: " + "; ".join(
            f"{w}: median {med / sc:.2e}, max {mx / sc:.2e} of the range"
            for w, (med, _, mx, sc) in zip(("sdf", "g", "color"), tf32_rd))
            + f" (a TF32 GEMM would {'fail' if any(mx > TOL_F32 * sc for _, _, mx, sc in tf32_rd) else 'pass'} "
            f"the {TOL_F32:g} limit)")
        rows["K2"] = dict(rows.get("K2", {}), f32_ms=ms, f32_plain_ms=plain_ms, f32_bound_ms=b_ms,
                          f32_max_abs_err=max(c[1] for c in checks))
        if not all(c[0] for c in checks):
            raise AssertionError("K2 f32 disagrees with its plain version")

    def kernel_k3_f32():
        """The frozen K3 in f32 on one fit step's own inputs and
        cotangents, and on unit cotangents at its points: dp, drotT, doff
        in L2; by torch.profiler's kernel names, its f32 GEMMs and no dW /
        db kernel."""
        args = fit_inputs()
        pts, pack = args[0], args[4]
        n = pts.shape[0]
        before = FF.KERNEL_BWD.launches
        got, checks, _ = f32_bwd_check(torch, args, want_dw=False, shared_g=False)
        _, units, _ = f32_bwd_check(torch, args, want_dw=False, seed=3, shared_g=False)
        oks = [c.ok for c in checks + units]
        errs = [c.max_abs for c in checks]
        lines = [c.text for c in checks] + [f"unit cotangents, {c.text}" for c in units]
        no_dw = got.dws is None and got.dcws is None
        names = device_kernel_names(torch, lambda: FF.hand_fine_color_bwd(*args, want_dw=False))
        launched = FF.KERNEL_BWD.launches - before == 3
        f32_inputs["bwd_calls"] = record_perpoint_calls(
            lambda: FF.hand_fine_color_bwd(*args, want_dw=False))
        f32_inputs["bwd_pose"] = (pts, tuple(args[1:4]))

        def count(*keys):
            return sum(c for k, c in names.items() if any(x in k for x in keys))

        dw_launches = count("gemm_tn", "colsum_partial", "reduce_partials", "trunk_dw_f32")
        f32_gemms = count("gemm_f32_kernel")
        bf16_gemms = count("gemm_kernel")   # the bf16 GEMM's name is not a part of the f32 one's
        color32, color_dz = count("color_fwd_f32_kernel", "color_bwd_f32_kernel"), count(
            "color_dz_kernel")
        seen = launched and color32 > 0 and sum(names.values()) > 0
        ms = cuda_ms(torch, lambda: FF.hand_fine_color_bwd(*args, want_dw=False), 5)
        plain_ms = cuda_ms(torch, lambda: FF.hand_fine_color_plain_bwd(*args, want_dw=False), 2)
        weights = [*pack.ws, *pack.bs, *pack.cws, *pack.cbs]
        n_bytes = nbytes([*args[:4], *args[5:], *weights]) + 12 * n + 4 * 9 * 128
        flops = k3_frozen_flops(fn.hand_sdf, fn.hand_color, n)
        b_ms, b_by = bound(flops, n_bytes, PEAK_F32_3XTF32_FLOPS)
        log(f"K3 f32 frozen hand_fine_color_bwd: {n} pts; {'; '.join(lines)}; no weight "
            f"gradient {no_dw}; kernels by name: {sum(names.values())} launches, the fused color "
            f"pair {color32}, f32 GEMMs {f32_gemms}, color_dz_kernel {color_dz}, bf16 GEMMs "
            f"{bf16_gemms}, dW/db kernels {dw_launches} (the profiler saw them: {seen}); kernel "
            f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, {flops / 1e12:.4f} TFLOP, {flops / n / 1e6:.3f} MFLOP/pt, "
            f"{flops / ms / 1e9:.1f} TFLOP/s)")
        for name, cnt in sorted(names.items(), key=lambda kv: -kv[1]):
            log(f"  x{cnt:<4d} {name.replace('honerf::', '')[:90]}")
        rows["K3"] = dict(rows.get("K3", {}), f32_ms=ms, f32_plain_ms=plain_ms, f32_bound_ms=b_ms,
                          f32_max_abs_err=max(errs))
        if not all(oks) or not no_dw:
            raise AssertionError("K3 f32 frozen disagrees with its plain version")
        if not seen or dw_launches or bf16_gemms or f32_gemms or color_dz:
            raise AssertionError("K3 f32 frozen: the fused color pair, and no GEMM, "
                                 "color_dz_kernel or dW/db kernel, not shown")

    def kernel_fit_modes_f32():
        """At what one '12' fit step in 'full_nocolor' and in 'pallas' hands
        its kernels (37,632 points): the forward (K2 f32 without the color
        net: out, g, e; K5 f32: out, u) within TOL_F32 of the range at the
        median and the max, and the frozen backward (K3 f32 without the
        color net; K6 f32) on the step's own cotangents and on seeded unit
        cotangents at its inputs under the f32 rule."""
        bad = []
        for mode, label, fwd, plain_fwd, names, lead in (
                ("full_nocolor", "K2/K3 f32 no-color", FF.hand_fine_color_fwd,
                 FF.hand_fine_color_plain, ("out", "g", "e"), 5),
                ("pallas", "K5/K6 f32", FT.hand_trunk_sdf_u_fwd, FT.hand_trunk_sdf_u_plain,
                 ("out", "u"), 2)):
            held = {}
            rec = record_perpoint_calls(lambda: held.setdefault(
                "args", fit_step_inputs(torch, fn, dev, "12", mode=mode)))
            args = held["args"]
            if mode == "pallas":
                f32_inputs["pallas_calls"] = rec   # one '12' 'pallas' fit step's packs
            fargs = args[:lead]
            checks = [compare(torch, w, a, b, TOL_F32, TOL_F32)
                      for w, a, b in zip(names, fwd(*fargs), plain_fwd(*fargs))]
            got, own, _ = f32_bwd_check(torch, args, mode, want_dw=False)
            _, units, _ = f32_bwd_check(torch, args, mode, want_dw=False, seed=3)
            frozen = got.dws is None if mode != "pallas" else got[1] is None
            log(f"{label} at a '12' fit step ({args[0].shape[0]} pts): forward "
                + "; ".join(c[2] for c in checks) + "; frozen backward on the step's "
                "cotangents: " + "; ".join(c.text for c in own) + "; on unit cotangents: "
                + "; ".join(c.text for c in units) + f"; no weight gradient {frozen}")
            if not (all(c[0] for c in checks) and all(c.ok for c in own + units) and frozen):
                bad.append(label)
        assert not bad, f"disagrees with its plain version at a fit step: {bad}"

    fit_kernels = {"K1": FH.KERNEL, "K2": FF.KERNEL, "K3": FF.KERNEL_BWD,
                   "K5": FT.KERNEL_FWD, "K6": FT.KERNEL_BWD, "EMBED": FH.EMBED,
                   "COLSUM": FT.COLSUM, "UCHAIN": FT.UCHAIN, "BWDREV": FF.BWDREV,
                   "PACK": FT.PACK, "POSE": FF.POSE, "GEMM_F32": FH.GEMM_F32,
                   "TFWD32": FT.TRUNK_FWD_F32, "TUCH32": FT.TRUNK_UCHAIN_F32,
                   "TUT32": FT.TRUNK_UT_F32, "TDZ32": FT.TRUNK_DZ_F32,
                   "CFWD32": FF.COLOR_FWD_F32, "CBWD32": FF.COLOR_BWD_F32, "COLOR_DZ": FF.COLOR_DZ}
    # a fit step's K3, K5 and K6 take its 37,632 fine points in two f32
    # passes: two pose sums a K3 call, two packs a K5 or K6 call (one pass
    # where a call takes at most half a chunk)
    def passes_ok(n, calls):
        return calls <= n <= 2 * calls

    def fit():
        """The fitting CLI, '1' then '12', on a synthetic catch sequence in a
        temporary workspace (kept for the fit modes phase); then ms per
        step of each fit type through the runner's loop."""
        import pickle
        import tempfile

        from honerf_torch.cli import fitting_single

        ws = tempfile.mkdtemp(prefix="chip_smoke_fit_")
        f32_inputs["ws"] = ws
        confs, gen_s = fit_workspace(torch, fn, dev, ws)
        H, W = fn.conf.get_list("dataset.image_size")
        log(f"fit: synthetic catch sequence (1 frame, 8 views, {H}x{W}) and checkpoints in "
            f"{gen_s:.1f} s")
        total = {}
        for ft in ("1", "12"):
            for k in fit_kernels.values():
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fitting_single.main(["--conf", confs[ft], "--case", f"{ft}_8view"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches = {name: k.launches for name, k in fit_kernels.items()}
            for name, c in launches.items():
                total[name] = total.get(name, 0) + c
            path = os.path.join(ws, "fit_res", "view_8", ft, "person1_bean", "seq0",
                                f"pose_{ft}", "0.pickle")
            with open(path, "rb") as f:
                pose = pickle.load(f)
            shapes = {k: tuple(v.shape) for k, v in pose.items()}
            want = {"pred_joint3d": (21, 3), "pred_Ro": (3, 3), "pred_To": (3,),
                    "gt_joint3d": (21, 3), "gt_Ro": (3, 3), "gt_To": (3,)}
            finite = all(np.isfinite(v).all() and v.dtype == np.float32
                         for v in pose.values())
            moved = float(np.abs(pose["pred_joint3d"] - pose["gt_joint3d"]).max())
            log(f"fit {ft}: the CLI in {cli_s:.1f} s ({FIT_ITERS} iterations x 8 views, "
                f"loading and checkpoints included); launches {launches}; pickle {shapes}, "
                f"f32 and finite {finite}; |pred - gt| joints up to {moved:.4f} m")
            assert shapes == want and finite, "the pose pickle is not the JAX runner's"
            assert (launches["K1"] and launches["K2"] and launches["K3"] and launches["EMBED"]
                    and launches["TFWD32"] and launches["TUCH32"] and launches["TUT32"]
                    and launches["TDZ32"] and launches["BWDREV"] and launches["CFWD32"]
                    and launches["CBWD32"]), \
                f"a kernel of the fitting path did not launch: {launches}"
            assert not (launches["K5"] or launches["K6"] or launches["COLSUM"]
                        or launches["PACK"] or launches["UCHAIN"] or launches["GEMM_F32"]
                        or launches["COLOR_DZ"]), f"stray launches {launches}"
            assert passes_ok(launches["POSE"], launches["K3"]), \
                f"{launches['POSE']} pose sums for {launches['K3']} K3 calls: {launches}"
        f32_inputs["confs"] = confs
        rows["K2"] = dict(rows.get("K2", {}), f32_launches=total["K2"])
        rows["K3"] = dict(rows.get("K3", {}), f32_launches=total["K3"])
        for name in ("UCHAIN", "BWDREV", "POSE", "TFWD32", "TUCH32", "TUT32", "TDZ32", "CFWD32",
                     "CBWD32"):
            rows[name] = dict(rows.get(name, {}), fit_launches=total[name])
        # ms per step of each fit type through the runner's own loop
        for ft in ("1", "12"):
            one = runner_steps(confs[ft], ft, f"fit {ft}")
            if ft == "12":
                f32_inputs["profile"] = one

    def runner_steps(conf_path, ft, label):
        """TRAIN_WARMUP + TRAIN_STEPS fit steps of the conf through the
        runner's own loop (host ray sampling and upload included): ms per
        step and seconds a frame at the reference budget.  Returns a
        closure that runs one more step."""
        from honerf_torch.data.fit_datasets import load_fit_sequence
        from honerf_torch.fit.runner import SingleFitRunner
        from honerf_torch.fit.single import init_fit_state

        r = SingleFitRunner(conf_path, f"{ft}_8view", device=dev)
        seq = load_fit_sequence(r.data_root, "person1_bean", "seq0", r.view_num, r.fit_type,
                                r.fit_res_root, r.exp_root, image_hw=(r.H, r.W))
        frame = seq.frames[0]
        step = r.make_step(r.nets_for(seq))
        consts = r.frame_consts(seq, frame)
        state = init_fit_state(dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        torch.cuda.reset_peak_memory_stats()
        metrics = []
        n_views = len(frame.views)

        def one(i=0):
            batch = r.device_batch(r.view_batch(frame, i % n_views, r.fcfg.batch_size), consts)
            return step(state, batch, gen)[1]

        for i in range(TRAIN_WARMUP):
            metrics.append(one(i))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(TRAIN_STEPS):
            metrics.append(one(i))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / TRAIN_STEPS
        loss = torch.stack([m["loss"] for m in metrics])
        log(f"{label}: {ms:.2f} ms/step ({TRAIN_STEPS} steps of {r.fcfg.batch_size} rays "
            f"after {TRAIN_WARMUP} warm-up, host clock, ray sampling and upload "
            f"included); {ms * FIT_BUDGET[ft] / 1e3:.2f} s a frame at the reference "
            f"budget of {FIT_BUDGET[ft]} steps; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; loss first "
            f"{float(loss[0]):.4f} last {float(loss[-1]):.4f}")
        assert bool(torch.isfinite(loss).all()), "a fit loss is not finite"
        return one

    def fit_modes():
        """fitting_single '12' with train.fused_fine = 'full_nocolor' and
        'pallas' (the confs' f32 trunks; '1''s poses from the fit phase):
        the CLI with its launch counts and pose pickle, then ms per step
        through the runner's loop; one step's kernels by name: the fused
        f32 backward pair and no dW / db kernel (the nets are frozen)."""
        import pickle
        import shutil

        from honerf_torch.cli import fitting_single

        ws, confs = f32_inputs.get("ws"), f32_inputs.get("confs")
        assert confs, "the fit phase did not run"
        with open(confs["12"]) as f:
            text = f.read()
        bad = []
        for mode, want in (("full_nocolor", ("K1", "K2", "K3", "EMBED", "TFWD32", "TUCH32",
                                              "TUT32", "TDZ32", "BWDREV", "POSE")),
                           ("pallas", ("K1", "K5", "K6", "EMBED", "TFWD32", "TUCH32", "TUT32",
                                       "TDZ32", "PACK"))):
            label = f"fit 12 {mode}"
            root = os.path.join(ws, f"fit_res_{mode}")
            shutil.copytree(os.path.join(ws, "fit_res", "view_8", "1"),
                            os.path.join(root, "view_8", "1"))
            conf = os.path.join(ws, f"fit_12_{mode}.conf")
            with open(conf, "w") as f:
                f.write(text.replace(f'fit_res_root = "{ws}/fit_res"', f'fit_res_root = "{root}"')
                        .replace("batch_size = 196", f'batch_size = 196\n  fused_fine = "{mode}"'))
            for k in fit_kernels.values():
                k.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fitting_single.main(["--conf", conf, "--case", "12_8view"])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            launches = {name: k.launches for name, k in fit_kernels.items()}
            with open(os.path.join(root, "view_8", "12", "person1_bean", "seq0", "pose_12",
                                   "0.pickle"), "rb") as f:
                pose = pickle.load(f)
            finite = all(np.isfinite(v).all() for v in pose.values())
            log(f"{label}: the CLI in {cli_s:.1f} s; launches {launches}; pickle finite {finite}")
            one = runner_steps(conf, "12", label)
            names = device_kernel_names(torch, one)

            def count(*keys):
                return sum(c for k, c in names.items()
                           if "honerf" in k and any(x in k for x in keys))

            dw = count("gemm_tn", "colsum_partial", "reduce_partials", "trunk_dw_f32")
            f32_g = count("gemm_f32_kernel")
            bwd32 = count("hand_trunk_ut_f32_kernel", "hand_trunk_dz_f32_kernel")
            log(f"{label}: one step's kernels by name: {sum(names.values())} launches, f32 "
                f"GEMMs {f32_g}, the fused f32 backward pair {bwd32}, dW/db kernels {dw}")
            idle = [k for k in want if not launches[k]]
            stray = [k for k in ("K2", "K3", "K5", "K6", "COLSUM", "BWDREV", "PACK", "POSE",
                                 "UCHAIN") if k not in want and launches[k]]
            passes = (passes_ok(launches["POSE"], launches["K3"])
                      and passes_ok(launches["PACK"], launches["K5"] + launches["K6"]))
            if idle or stray or not finite or dw or f32_g or not bwd32 or not passes:
                bad.append(label)
            if mode == "pallas":
                rows["PACK"] = dict(rows.get("PACK", {}), fit_launches=launches["PACK"])
        assert not bad, f"a fit mode's path is not as expected: {bad}"

    def fit_check():
        """One '12' step on the card against the CPU at the card's ladder
        samples: the whole step in f32 (no K1) on fit_batch's rays against
        the CPU's f64 step; on fit_grid_batch's rays the card's f32 step
        against the CPU's in each fine-pass mode; the render terms' hand-pose
        gradients on their own, against the CPU's f32 step on fit_grid_batch's
        rays and under the f64 rule on fit_batch's; then with
        K1 (its plain version on the CPU) on FIT_CHECK_SEEDS batches against
        the f64 step, with K1 at the step's own ladder points against its
        plain version."""
        bad = []
        cases = ([(fit_batch, False, FIT_CHECK_SEEDS[0], "full")]
                 + [(fit_grid_batch, False, FIT_CHECK_SEEDS[0], mode)
                    for mode in ("full", "full_nocolor", "pallas")]
                 + [(fit_grid_batch, True, seed, "full") for seed in FIT_CHECK_SEEDS])
        for batch_fn, ladder, seed, mode in cases:
            grid = batch_fn is fit_grid_batch
            direct = grid and not ladder     # the whole step: card vs CPU f32
            r = fit_check_readings(torch, fn, dev, fused_ladder=ladder, seed=seed, mode=mode,
                                   batch_fn=batch_fn, terms=not ladder)
            label = (f"fit check {mode} ({'head-on grid' if grid else 'random rays'}, "
                     f"fused_ladder={ladder}, seed {seed})")
            log(f"{label}: one step of {FIT_CHECK_RAYS} rays; metrics " + "; ".join(
                f"{side}: " + ", ".join(f"{k} {v:.6g}" for k, v in m.items())
                for side, m in r.metrics.items()))
            log(f"{label}: the two ladders' samples {r.ladder_median:.2e} apart at the median, "
                f"{r.ladder_dz:.2e} at most; every side renders at the card's")
            if direct:
                c_loss, c_grad = r.card_cpu
                worst = max(max(c_loss.values()), max(c_grad))
                ok = worst <= TOL_FIT_HEAD_ON
                log(f"{label}: card vs CPU f32, loss terms " + ", ".join(
                    f"{k} {v:.1e}" for k, v in c_loss.items()) + "; pose gradients " + ", ".join(
                    f"{k} {x:.2e}" for k, x in zip(r.keys, c_grad))
                    + f"; worst {worst:.2e} (tol {TOL_FIT_HEAD_ON:g}){'' if ok else ' FAIL'}")
            else:
                ratios = fit_f64_ratios(r)
                ok = max(ratios) <= 1.0
                (c_loss, c_grad), (p_loss, p_grad) = r.card, r.cpu
                if ladder:
                    med, _, mx, scale = r.k1
                    k1_ok = med <= TOL_MEDIAN * scale and mx <= TOL_MAX * scale
                    ok = ok and k1_ok
                    log(f"{label}: K1 at the step's coarse ladder points against its plain "
                        f"version: |err| median {med / scale:.2e}, max {mx / scale:.2e} of the "
                        f"range {scale:.3e} (tol {TOL_MEDIAN:g}, {TOL_MAX:g})"
                        f"{'' if k1_ok else ' FAIL'}")
                log(f"{label}: distance from the CPU's f64 step, card / CPU f32: loss terms "
                    + ", ".join(f"{k} {c_loss[k]:.1e}/{p_loss[k]:.1e}" for k in c_loss)
                    + "; pose gradients " + ", ".join(
                        f"{k} {c:.2e}/{p:.2e}" for k, c, p in zip(r.keys, c_grad, p_grad))
                    + f"; worst {max(ratios):.3f} of the limit (card <= {FIT_FACTOR:g} x "
                    f"CPU + {TOL_FIT_F32:g}){'' if ok else ' FAIL'}")
            if r.render_card:
                if direct:
                    worst_r = max(r.render_card_cpu.values())
                    r_ok, limit = worst_r <= TOL_FIT_RENDER, f"tol {TOL_FIT_RENDER:g}"
                else:
                    worst_r = max(fit_render_ratios(r).values())
                    r_ok, limit = worst_r <= 1.0, "of the f64 rule"
                ok = ok and r_ok
                log(f"{label}: the render terms' hand-pose gradients, card vs CPU f32 (distance "
                    "from the CPU's f64 step, card / CPU f32): " + ", ".join(
                        f"{t} {r.render_card_cpu[t]:.2e} ({r.render_card[t]:.2e}/"
                        f"{r.render_cpu[t]:.2e})" for t in FIT_RENDER_TERMS)
                    + f"; worst {worst_r:.3g} ({limit}){'' if r_ok else ' FAIL'}")
            if not ok:
                bad.append(label)
        assert not bad, f"the card's fit step disagrees with the CPU's: {bad}"

    def perpoint_fit():
        """The reverse-chain transpose alone, f32, at the calls one fit
        step's frozen K3 f32 makes (recorded in the phase above), on the
        step's points and pose, against its plain version (bwdrev_readings:
        TOL_F32); the seed at the calls the split launches made there (K2's
        and K3's recompute passes: the fused u-chain seeds itself, and the
        phases above recorded none) against its plain version
        (seed_readings, bit for bit); the pose sums at that K3's calls and
        the pack at a '12' 'pallas' fit step's (pose_readings,
        pack_readings: bit for bit)."""
        fwd, bwd = f32_inputs.get("fwd_calls"), f32_inputs.get("bwd_calls")
        pal = f32_inputs.get("pallas_calls")
        assert fwd and bwd and bwd.bwdrev and bwd.pose, \
            "the K2 / K3 f32 phases recorded no per-point call"
        assert not (fwd.seed or bwd.seed), "a fit step's f32 trunk called the u-chain's seed"
        assert pal and pal.pack, "the fit modes phase recorded no pack"
        assert _tally(pal.pack) == pack_calls(torch)["fit step"], \
            f"a '12' 'pallas' fit step's packs {_tally(pal.pack)} are not pack_calls'"
        assert _tally(bwd.pose) == pose_calls(torch)["fit step"], \
            f"a fit step's pose sums {_tally(bwd.pose)} are not pose_calls'"
        pts, pose = f32_inputs["bwd_pose"]
        n_fit = pts.shape[0]
        C = FT.chunk_size(n_fit, "f32", FF.CHUNK)
        seeds = seed_readings(torch, dev, [(min(C, n_fit - s0), 256, 256, torch.float32)
                                           for s0 in range(0, n_fit, C)] * 2)
        revs = bwdrev_readings(torch, dev, pose, pts, bwd.bwdrev)
        packs = pack_readings(torch, dev, _tally(pal.pack))
        poses = pose_readings(torch, dev, _tally(bwd.pose))
        log_pack_pose("fit step", packs, poses)
        pack_pose_row("fit_", packs, poses, rows)
        for r in seeds:
            log(f"UCHAIN fit step: {r.count} x {r.m} rows x {r.width} {r.dtype}: the same bits as "
                f"uchain_seed_plain {r.same}, as torch.mul {r.same_lib}; kernel {r.ms:.4f} ms, "
                f"torch.mul {r.lib_ms:.4f} ms, bound {r.bound_ms:.4f} ms{'' if r.ok else ' FAIL'}")
        for r in revs:
            log(f"BWDREV fit step: {r.count} x {r.m} pts {r.dtype}; {r.text}; kernel "
                f"{r.ms:.4f} ms, plain {r.plain_ms:.3f} ms, bound {r.bound_ms:.4f} ms "
                f"({r.bound_by}): {r.bound_ms / r.ms:.2f} of the bound")
        u, b = weighted(seeds), weighted(revs, ("ms", "plain_ms", "bound_ms"))
        log(f"a fit step's {sum(r.count for r in seeds)} seeds: kernel {u['ms']:.4f} ms, torch.mul "
            f"{u['lib_ms']:.4f} ms, bound {u['bound_ms']:.4f} ms ({u['bound_ms'] / u['ms']:.2f}); "
            f"its {sum(r.count for r in revs)} reverse-chain transposes: kernel {b['ms']:.4f} ms, "
            f"plain {b['plain_ms']:.3f} ms, bound {b['bound_ms']:.4f} ms "
            f"({b['bound_ms'] / b['ms']:.2f})")
        rows["UCHAIN"] = dict(rows.get("UCHAIN", {}), fit_ms=u["ms"], fit_bound_ms=u["bound_ms"],
                              fit_library_ms=u["lib_ms"])
        rows["BWDREV"] = dict(rows.get("BWDREV", {}), fit_ms=b["ms"], fit_plain_ms=b["plain_ms"],
                              fit_bound_ms=b["bound_ms"])
        if not all(r.ok for r in seeds + revs + packs + poses):
            raise AssertionError("a per-point kernel disagrees with its plain version at a fit "
                                 "step")

    def fit_profile():
        fn_ = f32_inputs.get("profile")
        assert fn_ is not None, "the fit phase did not run"
        fn_()
        device_profile(torch, "one '12' fit step of 196 rays", fn_, points=37632 // 2)

    def fused_trunk_f32():
        """The f32 trunk's pair (hand_trunk_fwd_f32_kernel, then
        hand_uchain_f32_kernel) alone at the calls one '12' fit step makes
        (recorded here through the runner's loop) and one f32 'full' and
        'pallas' step and one f32 request make (recorded by the f32
        phases), and at ragged sizes: every output against the plain
        versions, f64 and the split launches (trunk32_readings), timed
        beside the split launches, the plain versions and the bounds; each
        path's launches of gemm_f32_kernel, uchain_seed_kernel and the pair
        against TRUNK32_LAUNCHES."""
        fn_ = f32_inputs.get("profile")
        assert fn_ is not None, "the fit phase did not run"
        counted = (FH.GEMM_F32, FT.UCHAIN, FT.TRUNK_FWD_F32, FT.TRUNK_UCHAIN_F32,
                   FT.TRUNK_UT_F32, FT.TRUNK_DZ_F32, FT.TRUNK_DW_F32, FH.GEMM_TN_F32, FT.COLSUM,
                   FF.COLOR_FWD_F32, FF.COLOR_BWD_F32, FF.COLOR_DZ)
        for k in counted:
            k.launches = 0
        TRUNK32_CALLS["'12' fit step"] = record_trunk_calls(fn_)
        TRUNK_BWD32_CALLS["'12' fit step"] = TRUNK32_CALLS["'12' fit step"]
        torch.cuda.synchronize()
        TRUNK32_COUNTS["'12' fit step"] = tuple(k.launches for k in counted)
        bad = []
        for label, want in TRUNK32_LAUNCHES.items():
            got = TRUNK32_COUNTS.get(label)
            good = got is not None and tuple(got) == want
            log(f"fused trunk f32, {label}: launches of gemm_f32_kernel, uchain_seed_kernel, "
                f"hand_trunk_fwd_f32_kernel, hand_uchain_f32_kernel, hand_trunk_ut_f32_kernel, "
                f"hand_trunk_dz_f32_kernel, trunk_dw_f32_kernel, gemm_tn_f32_kernel, "
                f"colsum_partial_kernel, color_fwd_f32_kernel, color_bwd_f32_kernel, "
                f"color_dz_kernel: {got} (expected {want})"
                f"{'' if good else ' FAIL'}")
            bad += [] if good else [label]
        nets = trunk32_nets(torch, dev)
        groups = {}
        for label, calls in TRUNK32_CALLS.items():
            rs = groups[label] = trunk32_readings(torch, dev, nets, trunk32_pairs(calls))
            for r in rs:
                log(f"fused trunk f32, {label}: {trunk32_text(r)}")
            t = weighted(rs, ("ms", "split_ms", "plain_ms", "bound_ms", "fwd_ms", "uc_ms",
                              "fwd_bound_ms", "uc_bound_ms"))
            log(f"fused trunk f32, {label}'s {sum(r.count for r in rs)} pairs: "
                f"hand_trunk_fwd_f32_kernel {t['fwd_ms']:.4f} ms (bound "
                f"{t['fwd_bound_ms']:.4f}), hand_uchain_f32_kernel {t['uc_ms']:.4f} ms (bound "
                f"{t['uc_bound_ms']:.4f}); the pair {t['ms']:.4f} ms against the split "
                f"launches' {t['split_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms: "
                f"{t['bound_ms'] / t['ms']:.2f} of it (the split's "
                f"{t['bound_ms'] / t['split_ms']:.2f})")
            bad += [trunk32_text(r) for r in rs if not r.ok]
        for r in trunk32_readings(torch, dev, nets, ragged_trunk32_pairs(), timed=False):
            log(f"fused trunk f32, ragged: {trunk32_text(r)}")
            bad += [] if r.ok else [trunk32_text(r)]
        every = [r for rs in groups.values() for r in rs]
        keys = ("ms", "split_ms", "plain_ms", "bound_ms", "fwd_ms", "uc_ms", "fwd_plain_ms",
                "uc_plain_ms", "fwd_bound_ms", "uc_bound_ms")
        tot = {label: weighted(rs, keys) for label, rs in groups.items()}
        req = tot["f32 request"]
        for key, kern, part in (("TFWD32", FT.TRUNK_FWD_F32, "fwd"),
                                ("TUCH32", FT.TRUNK_UCHAIN_F32, "uc")):
            rows[key] = dict(rows.get(key, {}), name=kern.name, route="cuda", source=kern.source,
                             replaces=kern.replaces, max_abs_err=max(r.max_abs for r in every),
                             ms=req[f"{part}_ms"], plain_ms=req[f"{part}_plain_ms"],
                             bound_ms=req[f"{part}_bound_ms"], bound_by="operations",
                             library_ms=None)
            for label, prefix in (("f32 'full' step", "step_"), ("f32 'pallas' step", "pallas_"),
                                  ("'12' fit step", "fit_")):
                rows[key].update({f"{prefix}ms": tot[label][f"{part}_ms"],
                                  f"{prefix}bound_ms": tot[label][f"{part}_bound_ms"]})
        for label, prefix in (("f32 request", "request_"), ("f32 'full' step", "step_"),
                              ("f32 'pallas' step", "pallas_"), ("'12' fit step", "fit_")):
            rows["TFWD32"].update({f"{prefix}pair_ms": tot[label]["ms"],
                                   f"{prefix}pair_split_ms": tot[label]["split_ms"],
                                   f"{prefix}pair_bound_ms": tot[label]["bound_ms"]})
        rows["TFWD32"]["worst_l2_f64"] = max(r.worst_k for r in every)
        rows["TFWD32"]["split_worst_l2_f64"] = max(r.worst_s for r in every)
        if bad:
            raise AssertionError(f"the f32 trunk's pair disagrees with its plain version, f64, "
                                 f"the split launches, its bits or its launch counts: {bad}")

    def fused_trunk_bwd_f32():
        """The f32 trunk's backward pair (hand_trunk_ut_f32_kernel, then
        hand_trunk_dz_f32_kernel) alone at the calls one f32 'full',
        'full_nocolor' and 'pallas' step and one '12' fit step make
        (recorded by the f32 phases and the phase above), and at ragged
        sizes with and without dW: every output against the plain
        versions, f64 and the split launches (trunk_bwd32_readings), timed
        beside the split chain, the plain chains and the bounds; each path's
        launches of the pair (TRUNK32_LAUNCHES, read in the phase above)
        and its recorded calls, one of each kernel a pass."""
        bad = []
        for label, calls in TRUNK_BWD32_CALLS.items():
            bwd = [c for c in calls if c[0] in ("ut", "dz")]
            passes = len([c for c in calls if c[0] == "fwd" and c[3]])  # the keep recomputes
            good = len(bwd) == 2 * passes > 0
            log(f"fused trunk backward f32, {label}: {len(bwd)} calls of the pair for {passes} "
                f"backward passes{'' if good else ' FAIL'}")
            bad += [] if good else [f"{label}'s calls"]
        nets = trunk32_nets(torch, dev)
        groups = {}
        for label in ("f32 'full' step", "f32 'full_nocolor' step", "f32 'pallas' step",
                      "'12' fit step"):
            calls = TRUNK_BWD32_CALLS.get(label)
            if not calls:
                bad.append(f"{label} not recorded")
                continue
            rs = groups[label] = trunk_bwd32_readings(torch, dev, nets, trunk_bwd32_calls(calls))
            for r in rs:
                log(f"fused trunk backward f32, {label}: {trunk_bwd32_text(r)}")
            t = weighted(rs, ("ms", "split_ms", "plain_ms", "bound_ms", "ut_ms", "dz_ms",
                              "ut_bound_ms", "dz_bound_ms"))
            log(f"fused trunk backward f32, {label}'s {sum(r.count for r in rs)} chains: "
                f"hand_trunk_ut_f32_kernel {t['ut_ms']:.4f} ms (bound {t['ut_bound_ms']:.4f}: "
                f"{t['ut_bound_ms'] / t['ut_ms']:.2f} of it), hand_trunk_dz_f32_kernel "
                f"{t['dz_ms']:.4f} ms (bound {t['dz_bound_ms']:.4f}: "
                f"{t['dz_bound_ms'] / t['dz_ms']:.2f}); the chain {t['ms']:.4f} ms against the "
                f"split launches' {t['split_ms']:.4f} ms ({t['ms'] / t['split_ms']:.2f} of it), "
                f"bound {t['bound_ms']:.4f} ms: {t['bound_ms'] / t['ms']:.2f} of it (the "
                f"split's {t['bound_ms'] / t['split_ms']:.2f})")
            bad += [trunk_bwd32_text(r) for r in rs if not r.ok]
        for r in trunk_bwd32_readings(torch, dev, nets, ragged_trunk_bwd32_calls(),
                                      timed=False):
            log(f"fused trunk backward f32, ragged: {trunk_bwd32_text(r)}")
            bad += [] if r.ok else [trunk_bwd32_text(r)]
        every = [r for rs in groups.values() for r in rs]
        keys = ("ms", "split_ms", "plain_ms", "bound_ms", "ut_ms", "dz_ms", "ut_plain_ms",
                "dz_plain_ms", "ut_bound_ms", "dz_bound_ms")
        tot = {label: weighted(rs, keys) for label, rs in groups.items()}
        step = tot.get("f32 'full' step")
        for key, kern, part in (("TUT32", FT.TRUNK_UT_F32, "ut"),
                                ("TDZ32", FT.TRUNK_DZ_F32, "dz")):
            rows[key] = dict(rows.get(key, {}), name=kern.name, route="cuda", source=kern.source,
                             replaces=kern.replaces,
                             max_abs_err=max((r.max_abs for r in every), default=None),
                             ms=step and step[f"{part}_ms"],
                             plain_ms=step and step[f"{part}_plain_ms"],
                             bound_ms=step and step[f"{part}_bound_ms"], bound_by="operations",
                             library_ms=None)
            for label, prefix in (("f32 'full_nocolor' step", "nocolor_"),
                                  ("f32 'pallas' step", "pallas_"), ("'12' fit step", "fit_")):
                if label in tot:
                    rows[key].update({f"{prefix}ms": tot[label][f"{part}_ms"],
                                      f"{prefix}bound_ms": tot[label][f"{part}_bound_ms"]})
        for label, prefix in (("f32 'full' step", "step_"),
                              ("f32 'full_nocolor' step", "nocolor_"),
                              ("f32 'pallas' step", "pallas_"), ("'12' fit step", "fit_")):
            if label in tot:
                rows["TUT32"].update({f"{prefix}chain_ms": tot[label]["ms"],
                                      f"{prefix}chain_split_ms": tot[label]["split_ms"],
                                      f"{prefix}chain_bound_ms": tot[label]["bound_ms"]})
        rows["TUT32"]["worst_l2_f64"] = max((r.worst_k for r in every), default=None)
        rows["TUT32"]["split_worst_l2_f64"] = max((r.worst_s for r in every), default=None)
        if bad:
            raise AssertionError("the f32 trunk's backward pair disagrees with its plain "
                                 "versions, f64, the split launches, its bits or its calls: "
                                 f"{bad}")

    def fused_dw_f32():
        """An f32 pass's weight gradients in one launch (trunk_dw_f32_kernel)
        alone at the calls one f32 'full', 'full_nocolor' and 'pallas' step
        make (recorded by the f32 train phase; a '12' fit step, whose nets
        are frozen, makes none), and at ragged sizes with and without the
        color rows: every dW and db against trunk_dw_plain, f64 and the split
        sequence (trunk_dw32_readings), timed in turns beside the split
        sequence, the plain version and the bound; one launch a backward
        pass."""
        bad = []
        for label, calls in TRUNK_BWD32_CALLS.items():
            dws = trunk_dw32_calls(calls)
            passes = len([c for c in calls if c[0] == "ut" and c[2]])   # backward passes with dW
            color = [c for _, c in dws]
            good = len(dws) == passes and (all(color) if label == "f32 'full' step"
                                           else not any(color))
            log(f"fused dW f32, {label}: {len(dws)} launches for {passes} backward passes with "
                f"dW, color rows {color}{'' if good else ' FAIL'}")
            bad += [] if good else [f"{label}'s calls"]
        nets = trunk32_nets(torch, dev)
        groups = {}
        for label in ("f32 'full' step", "f32 'full_nocolor' step", "f32 'pallas' step"):
            calls = trunk_dw32_calls(TRUNK_BWD32_CALLS.get(label, []))
            if not calls:
                bad.append(f"{label} not recorded")
                continue
            rs = groups[label] = trunk_dw32_readings(torch, dev, nets, calls)
            for r in rs:
                log(f"fused dW f32, {label}: {trunk_dw32_text(r)}")
            t = weighted(rs, ("ms", "split_ms", "plain_ms", "bound_ms"))
            log(f"fused dW f32, {label}'s {sum(r.count for r in rs)} launches: "
                f"{t['ms']:.4f} ms against the split sequence's {t['split_ms']:.4f} ms "
                f"({t['ms'] / t['split_ms']:.2f} of it), plain {t['plain_ms']:.3f} ms, bound "
                f"{t['bound_ms']:.4f} ms: {t['bound_ms'] / t['ms']:.2f} of it (the split's "
                f"{t['bound_ms'] / t['split_ms']:.2f})")
            bad += [trunk_dw32_text(r) for r in rs if not r.ok]
        for r in trunk_dw32_readings(torch, dev, nets, ragged_trunk_dw32_calls(), timed=False):
            log(f"fused dW f32, ragged: {trunk_dw32_text(r)}")
            bad += [] if r.ok else [trunk_dw32_text(r)]
        every = [r for rs in groups.values() for r in rs]
        tot = {label: weighted(rs, ("ms", "split_ms", "plain_ms", "bound_ms"))
               for label, rs in groups.items()}
        step = tot.get("f32 'full' step")
        kern = FT.TRUNK_DW_F32
        rows["TDW32"] = dict(rows.get("TDW32", {}), name=kern.name, route="cuda",
                             source=kern.source, replaces=kern.replaces,
                             max_abs_err=max((r.max_abs for r in every), default=None),
                             ms=step and step["ms"], plain_ms=step and step["plain_ms"],
                             bound_ms=step and step["bound_ms"], bound_by="operations",
                             library_ms=None, step_split_ms=step and step["split_ms"],
                             worst_l2_f64=max((r.worst_k for r in every), default=None),
                             split_worst_l2_f64=max((r.worst_s for r in every), default=None))
        for label, prefix in (("f32 'full_nocolor' step", "nocolor_"),
                              ("f32 'pallas' step", "pallas_")):
            if label in tot:
                rows["TDW32"].update({f"{prefix}{k}": tot[label][k]
                                      for k in ("ms", "split_ms", "bound_ms")})
        if bad:
            raise AssertionError("the f32 weight gradients' launch disagrees with its plain "
                                 "version, f64, the split sequence, its bits or its calls: "
                                 f"{bad}")

    def fused_color_f32():
        """The f32 color net's two kernels (color_fwd_f32_kernel,
        color_bwd_f32_kernel) alone at the calls one f32 'full' step, one
        '12' fit step and one f32 request make (recorded by the f32 phases
        and the fused trunk f32 phase) and at ragged sizes: every output
        against the plain versions, f64 and the split launches
        (color32_readings), timed beside the split launches, the plain
        versions and the bounds; each path's recorded calls (the forward
        once a pass of K2 and of K3's recompute, the transpose once a pass
        of K3) and its launches (TRUNK32_COUNTS): gemm_f32_kernel and
        color_dz_kernel none."""
        bad = []
        # (forward calls, transpose calls, the transpose's dz rows) a path makes
        want_calls = {"f32 'full' step": (4, 2, True), "'12' fit step": (4, 2, False),
                      "f32 request": (16, 0, False)}
        for label, (nf, nb, dz) in want_calls.items():
            cs = color32_calls(TRUNK32_CALLS.get(label, []))
            fwd = [c for c in cs if c[0] == "cfwd"]
            bwd = [c for c in cs if c[0] == "cbwd"]
            k = dict(zip(TRUNK32_KERNELS, TRUNK32_COUNTS.get(label, ())))
            good = (len(fwd) == nf and len(bwd) == nb and all(c[2] == dz for c in bwd)
                    and sum(c[2] for c in fwd) == nb and k.get("GEMM_F32") == 0
                    and k.get("COLOR_DZ") == 0 and k.get("CFWD32") == nf
                    and k.get("CBWD32") == nb)
            log(f"fused color f32, {label}: {len(fwd)} forward calls ({sum(c[2] for c in fwd)} "
                f"keeping the relu rows), {len(bwd)} transpose calls (dz rows {dz}); launches "
                f"a {'request' if 'request' in label else 'step'}: color_fwd_f32_kernel "
                f"{k.get('CFWD32')}, color_bwd_f32_kernel {k.get('CBWD32')}, gemm_f32_kernel "
                f"{k.get('GEMM_F32')}, color_dz_kernel {k.get('COLOR_DZ')}"
                f"{'' if good else ' FAIL'}")
            bad += [] if good else [f"{label}'s calls or launches"]
        nets = trunk32_nets(torch, dev)
        groups = {}
        for label in want_calls:
            calls = color32_calls(TRUNK32_CALLS.get(label, []))
            if not calls:
                bad.append(f"{label} not recorded")
                continue
            rs = groups[label] = color32_readings(torch, dev, nets, calls)
            for r in rs:
                log(f"fused color f32, {label}: {color32_text(r)}")
            t = {kind: weighted([r for r in rs if r.kind == kind],
                                ("ms", "split_ms", "plain_ms", "bound_ms"))
                 for kind in ("cfwd", "cbwd")}
            pair = {k: sum(t[kind].get(k, 0.0) for kind in t)
                    for k in ("ms", "split_ms", "plain_ms", "bound_ms")}
            log(f"fused color f32, {label}'s {sum(r.count for r in rs)} calls: "
                + ", ".join(f"{name} {t[kind]['ms']:.4f} ms against the split launches' "
                            f"{t[kind]['split_ms']:.4f} ms (bound {t[kind]['bound_ms']:.4f})"
                            for kind, name in (("cfwd", "color_fwd_f32_kernel"),
                                               ("cbwd", "color_bwd_f32_kernel")) if t[kind])
                + f"; the pair {pair['ms']:.4f} ms against the split launches' "
                f"{pair['split_ms']:.4f} ms ({pair['ms'] / pair['split_ms']:.2f} of it), bound "
                f"{pair['bound_ms']:.4f} ms: {pair['bound_ms'] / pair['ms']:.2f} of it (the "
                f"split's {pair['bound_ms'] / pair['split_ms']:.2f})")
            bad += [color32_text(r) for r in rs if not r.ok]
        for r in color32_readings(torch, dev, nets, ragged_color32_calls(), timed=False):
            log(f"fused color f32, ragged: {color32_text(r)}")
            bad += [] if r.ok else [color32_text(r)]
        every = [r for rs in groups.values() for r in rs]
        keys = ("ms", "split_ms", "plain_ms", "bound_ms")
        for key, kern, kind in (("CFWD32", FF.COLOR_FWD_F32, "cfwd"),
                                ("CBWD32", FF.COLOR_BWD_F32, "cbwd")):
            mine = [r for r in every if r.kind == kind]
            tot = {label: weighted([r for r in rs if r.kind == kind], keys)
                   for label, rs in groups.items()}
            step = tot.get("f32 'full' step") or {}
            rows[key] = dict(rows.get(key, {}), name=kern.name, route="cuda", source=kern.source,
                             replaces=kern.replaces,
                             max_abs_err=max((r.max_abs for r in mine), default=None),
                             ms=step.get("ms"), plain_ms=step.get("plain_ms"),
                             bound_ms=step.get("bound_ms"), bound_by="operations",
                             library_ms=None, step_split_ms=step.get("split_ms"),
                             worst_l2_f64=max((r.worst_k for r in mine), default=None),
                             split_worst_l2_f64=max((r.worst_s for r in mine), default=None))
            for label, prefix in (("f32 request", "request_"), ("'12' fit step", "fit_")):
                if tot.get(label):
                    rows[key].update({f"{prefix}{k}": tot[label][k]
                                      for k in ("ms", "split_ms", "bound_ms")})
        if bad:
            raise AssertionError("the f32 color net's pair disagrees with its plain versions, "
                                 f"f64, the split launches, its bits or its calls: {bad}")

    phase("kernel K2 f32", kernel_k2_f32)
    phase("kernel K3 f32 frozen", kernel_k3_f32)
    phase("kernel fit modes f32", kernel_fit_modes_f32)
    phase("per-point kernels fit", perpoint_fit)
    try:
        phase("fit", fit)
        phase("fit modes", fit_modes)
        phase("fit check", fit_check)
        if "fit" not in failures:
            phase("fit profile", fit_profile)
            phase("fused trunk f32", fused_trunk_f32)
            phase("fused trunk backward f32", fused_trunk_bwd_f32)
            phase("fused dW f32", fused_dw_f32)
            phase("fused color f32", fused_color_f32)
        else:
            failures += ["fit profile", "fused trunk f32", "fused trunk backward f32",
                         "fused dW f32", "fused color f32"]
    finally:
        import shutil

        if f32_inputs.get("ws"):
            shutil.rmtree(f32_inputs["ws"], ignore_errors=True)


# -- video fitting, frame-batched fitting and result extraction (phases 40-43) --

VIDEO_CONFS = {ft: os.path.join(ROOT, "fit_confs", f"fit_{ft}_8views_0.conf")
               for ft in ("123", "1234")}
GET_RES_CONFS = {"12": os.path.join(ROOT, "fit_confs", "get_res_12.conf"),
                 "123": os.path.join(ROOT, "fit_confs", "get_res_123.conf"),
                 "render": os.path.join(ROOT, "fit_confs", "get_render_type12.conf")}
VIDEO_FRAMES = 5            # two 4-frame windows
VIDEO_EPOCHS, VIDEO_SUB_ITERS = 2, 1   # cut from the reference's 5 and 4
VIDEO_WARMUP, VIDEO_STEPS = 2, 6       # the timed loops of the video and batched phases
BATCH_G = 4                 # train.frames_per_batch of the batched phase
BATCH_ITERS = 1             # train.iter_num of its CLI run (cut from 25)
GET_RES_MESH = 64           # train.mesh_resolution of the get_res phase
VIDEO_SHIFT = 0.01          # each frame of the video check 1 cm further along x
# the video step's kernels on the card, by the profiler's names
VIDEO_NAMES = {"K1": ("hand_embed_kernel", "hand_trunk_fwd_kernel"),
               "TFWD32/TUCH32": ("hand_trunk_fwd_f32_kernel", "hand_uchain_f32_kernel"),
               "CFWD32/CBWD32": ("color_fwd_f32_kernel", "color_bwd_f32_kernel"),
               "TUT32/TDZ32": ("hand_trunk_ut_f32_kernel", "hand_trunk_dz_f32_kernel")}
VIDEO_STRAY = ("trunk_dw_f32_kernel", "gemm_tn", "colsum_partial", "reduce_partials",
               "gemm_f32_kernel", "color_dz_kernel")
# the fitting paths' launch counts: each of these launched, none of those
VIDEO_LAUNCHED = ("K1", "K2", "K3", "EMBED", "TFWD32", "TUCH32", "TUT32", "TDZ32", "CFWD32",
                  "CBWD32", "BWDREV", "POSE")
VIDEO_IDLE = ("K4", "K5", "K6", "TDW32", "GEMM_F32", "COLOR_DZ", "COLSUM", "PACK")
# get_res: the meshes' and inner ids' kernels, the render's, and what no
# forward-only path launches
GET_RES_LAUNCHED = {"meshes": ("K1", "K4"), "render": ("K1", "K2")}
GET_RES_IDLE = ("K3", "TUT32", "TDZ32", "CBWD32")
# the video check's tables after Adam (card vs CPU, and against f64 Adam):
# a table near 1 in f32 holds a ~1e-4 update to ~3e-4 of itself (its ulp),
# so these are held to 1e-3 of the update, the rest to TOL_FIT_HEAD_ON
TOL_VIDEO_TABLES = 1e-3
# K1's get_res mesh (mesh_rule with bf16): the share of its vertices within
# one voxel of the plain mesh, and the farthest one
MESH_BF16_SHARE, MESH_BF16_VOXELS = 0.99, 2.0


def start_video_sequence(root: str):
    """Write the synthetic catch sequence of the video phases (VIDEO_FRAMES
    frames, 8 views, the fit confs' 230x266) under root in a child process
    of its own (its numpy hand renderer takes ~12 s a frame), so that it
    runs beside the first phases.  Returns the process and the data
    root."""
    from honerf_torch.config import load_config

    H, W = load_config(FIT_CONFS["1"]).get_list("dataset.image_size")
    data = os.path.join(root, "data", "catch_sequence", "test")
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from honerf_torch.data.synthetic import generate_catch_sequence as g; "
            "g(sys.argv[2], n_frames=int(sys.argv[3]), n_views=8, H=int(sys.argv[4]), "
            "W=int(sys.argv[5]))")
    proc = subprocess.Popen([sys.executable, "-c", code, ROOT, data, str(VIDEO_FRAMES), str(H),
                             str(W)])
    return proc, data


def _fit_conf(src: str, dst: str, ws: str, data: str, train: str = "",
              fit_res_root: str = "") -> str:
    """A copy of a fit conf pointed at the workspace ws (its data, its
    checkpoints, fit_res_root or ws/fit_res), with `train` lines added."""
    with open(src) as f:
        text = f.read()
    for old, new in (('save_dir = "./fit_res/CASE_NAME/wmask"',
                      f'save_dir = "{ws}/fit_res/CASE_NAME/wmask"\n'
                      f'  fit_res_root = "{fit_res_root or ws + "/fit_res"}"\n'
                      f'  exp_root = "{ws}/exp"'),
                     ('fitdata_dir = "./data/catch_sequence/test"', f'fitdata_dir = "{data}"'),
                     ("batch_size = 196", "batch_size = 196\n" + train)):
        assert text.count(old) == 1, f"{src}: {old!r}"
        text = text.replace(old, new)
    with open(dst, "w") as f:
        f.write(text)
    return dst


def video_workspace(torch, fn, dev, ws: str, data: str):
    """The video phases' workspace in ws (the sequence under data written
    by start_video_sequence): fit_nets's nets as offline checkpoints, '1''s
    pose pickles at the sequence's initial estimates (the '1' stage itself
    runs in the fit phase), and the confs: '12' batched (frames_per_batch
    BATCH_G, iter_num BATCH_ITERS), '123' and '1234' (epochs VIDEO_EPOCHS,
    sub_iters VIDEO_SUB_ITERS), get_res '12' and '123' (mesh_resolution
    GET_RES_MESH) and the render conf at 8 views (its own 3 would read
    3-view fits) on frame 0's '12' pose under fit_res_render."""
    from honerf_torch.data.fit_datasets import load_fit_sequence
    from honerf_torch.fit.runner import SingleFitRunner
    from honerf_torch.fit.single import final_pose_numpy, init_pose_params
    from honerf_torch.train.checkpoints import save_checkpoint

    for kind, path in (("hand", "person1/wmask_realhand"), ("obj", "bean/wmask_realobj")):
        save_checkpoint(os.path.join(ws, "exp", path, "checkpoints", "ckpt_000000.npz"),
                        {"params": clone_tree(fn.nets[kind], torch.device("cpu"))})
    confs = {"12": _fit_conf(FIT_CONFS["12"], os.path.join(ws, "fit_12_batched.conf"), ws, data,
                             f"  iter_num = {BATCH_ITERS}\n  frames_per_batch = {BATCH_G}")}
    for ft, src in VIDEO_CONFS.items():
        confs[ft] = _fit_conf(src, os.path.join(ws, f"fit_{ft}.conf"), ws, data,
                              f"  epochs = {VIDEO_EPOCHS}\n  sub_iters = {VIDEO_SUB_ITERS}")
    for key in ("12", "123"):
        confs[f"get_res_{key}"] = _fit_conf(GET_RES_CONFS[key],
                                            os.path.join(ws, f"get_res_{key}.conf"), ws, data,
                                            f"  mesh_resolution = {GET_RES_MESH}")
    render = _fit_conf(GET_RES_CONFS["render"], os.path.join(ws, "get_render_12.conf"), ws, data,
                       fit_res_root=f"{ws}/fit_res_render")
    with open(render) as f:
        text = f.read()
    with open(render, "w") as f:
        f.write(text.replace("view_num = 3", "view_num = 8"))
    confs["render"] = render
    r = SingleFitRunner(confs["12"], "1_8view", device=dev)
    seq = load_fit_sequence(data, "person1_bean", "seq0", "8", "1", r.fit_res_root, r.exp_root,
                            image_hw=(r.H, r.W))
    pose_dir = os.path.join(ws, "fit_res", "view_8", "1", "person1_bean", "seq0", "pose_1")
    os.makedirs(pose_dir)
    for frame in seq.frames:
        r.save_pose(os.path.join(pose_dir, f"{frame.frame_id}.pickle"),
                    final_pose_numpy(init_pose_params(dev), r.frame_consts(seq, frame)), frame)
    return confs


def mesh_rule(torch, dev, g_kernel, g_plain, bf16: bool = False):
    """(ok, text): a kernel's sdf grid against its plain version's, the
    median point within TOL_MEDIAN of the range, and both meshed under the
    K4 mesh check's rule (vertex and triangle counts within 1%, every
    kernel vertex within one voxel of the plain mesh) at the level halfway
    between the plain grid's minimum and its median: random weights put no
    zero level in a get_res box, and the hand's field there is flat at its
    0.2 background over most of the box, where any level meshes noise.
    With `bf16` (K1, bf16 weights) at least MESH_BF16_SHARE of the kernel's
    vertices within one voxel and every one within MESH_BF16_VOXELS: K1's
    bf16 flips move a grid point by up to ~3.5e-3 (1.2% of a get_res box's
    ~0.3 range, over TOL_MAX), and the random hand field's shallowest 1% of
    its iso-band (< 1 /m) turns that into more than a voxel (4.6 mm): at
    posed_hand_example's pose 0.55% of 2,011 vertices, up to 1.22 voxels
    (an H100's reading)."""
    import numpy as np

    from honerf_torch.extract import marching_cubes

    med, _, mx, scale = err_readings(torch, torch.as_tensor(g_kernel, device=dev),
                                     torch.as_tensor(g_plain, device=dev))
    level = 0.5 * (float(g_plain.min()) + float(np.median(g_plain)))
    (vk, tk), (vp, tp) = marching_cubes(g_kernel, level), marching_cubes(g_plain, level)
    a = torch.as_tensor(vk, device=dev).double()
    b = torch.as_tensor(vp, device=dev).double()
    dist = torch.cat([torch.cdist(a[s:s + 4096], b).min(dim=1).values
                      for s in range(0, a.shape[0], 4096)]) if len(vk) and len(vp) else None
    far = float(dist.max()) if dist is not None else float("inf")
    within = float((dist <= 1.0).double().mean()) if dist is not None else 0.0
    rel_v = abs(len(vk) - len(vp)) / max(len(vp), 1)
    rel_t = abs(len(tk) - len(tp)) / max(len(tp), 1)
    max_vox, share = (MESH_BF16_VOXELS, MESH_BF16_SHARE) if bf16 else (1.0, 1.0)
    ok = (bool(np.isfinite(g_kernel).all()) and med <= TOL_MEDIAN * scale and len(vp) > 0
          and rel_v <= 1e-2 and rel_t <= 1e-2 and far <= max_vox and within >= share)
    return ok, (f"|err| median {med:.2e}, max {mx:.2e} of the range {scale:.3e} (median tol "
                f"{TOL_MEDIAN:g}); at the level {level:.4f}: {len(vk)} / {len(vp)} vertices, "
                f"{len(tk)} / {len(tp)} triangles (tol 1e-2), {within:.5f} of the kernel's "
                f"vertices within one voxel of the plain mesh (tol {share:g}), the farthest "
                f"{far:.2f} voxels (tol {max_vox:g}){'' if ok else ' FAIL'}")


def video_rays(conf_path: str = VIDEO_CONFS["1234"]) -> int:
    """A video conf's rays a frame: train.rays_per_frame, VideoFitRunner's
    40 where the conf leaves it unset (the fit confs do)."""
    from honerf_torch.config import load_config
    from honerf_torch.fit.runner import VideoFitRunner

    return load_config(conf_path).get_int("train.rays_per_frame",
                                          VideoFitRunner.RAYS_PER_FRAME)


def video_check_batch(torch, idx, device, n_rays: int = 0):
    """The video check's window batch: frame i of the sequence is
    fit_grid_batch(seed=i)'s head-on rays (n_rays of a square grid over
    +-0.1 of the image plane, the video path's video_rays() by default)
    with its hand and object moved by i x VIDEO_SHIFT (a pose of its own;
    one camera, one object)."""
    import numpy as np

    from honerf_torch.data.synthetic import look_at_camera, posed_hand_example

    n_rays = n_rays or video_rays()
    joints = posed_hand_example()[0]
    center = joints.mean(0)
    R, T = look_at_camera(np.asarray(center + [0.0, 0.2, -0.9]), center)
    side = int(np.ceil(n_rays ** 0.5))
    g = np.linspace(-0.1, 0.1, side, dtype=np.float32)
    xy = np.stack(np.meshgrid(g, g), -1).reshape(-1, 2)[:n_rays]
    frames = []
    for i in idx:
        b = {k: v.cpu().numpy() for k, v in fit_batch(torch, n_rays, "cpu", seed=i).items()}
        move = np.asarray([i * VIDEO_SHIFT, 0.0, 0.0], np.float32)
        for k in ("joints_pred", "gt_joint3d", "To_pred", "To_gt"):
            b[k] = b[k] + move
        b["rays_xy"] = xy
        frames.append(b)
    shared = ("cam_R", "cam_T", "focal", "principal", "obj_verts")
    out = {k: np.stack([f[k] for f in frames]) for k in frames[0] if k not in shared}
    out.update({k: frames[0][k] for k in shared})
    out.update(cam_R=R, cam_T=T)
    batch = {k: torch.as_tensor(np.asarray(v, np.float32), device=device) for k, v in out.items()}
    batch["index"] = torch.as_tensor(list(idx), dtype=torch.int64, device=device)
    batch["anchor_enabled"] = torch.ones((), device=device)
    return batch


def video_check_readings(torch, fn, dev, fit_type: str = "1234"):
    """Two video steps (windows [0, 3] then [1, 4] of a VIDEO_FRAMES-frame
    sequence, video_check_batch's head-on rays, perturb 0) from the same
    tables near their start on three sides: the card (K1's ladder, K2 f32
    and the frozen K3 f32), the CPU (their plain versions) and the CPU in
    f64 (the autograd field), each of the CPU's ladders replaced by the
    card's samples in call order, as fit_check_readings does.  Per step:

      f64:     each metric's and each table gradient's distance from the
               f64 step, the card's over FIT_FACTOR x the CPU f32's +
               TOL_FIT_F32 (fit_check_readings' f64 rule; on an H100 the
               small palm_angle gradient sits 2-3e-4 from the CPU f32's, 3x
               the CPU's own distance from f64, beyond the head-on 1e-4);
      whole:   the six gradients as one vector, card vs CPU f32 (relative
               L2; TOL_FIT_HEAD_ON, the head-on fit check's limit);
      updates: each table's change, card vs CPU f32 (TOL_VIDEO_TABLES).

    And two readings of the card alone: frames, the first step's color and
    mask losses against the mean of the single fit loss
    (fit.single.make_single_fit_loss) of each frame on its own row and
    rays at the video step's samples of that frame (TOL_FIT_HEAD_ON: a
    step that renders a frame with another frame's bone transforms moves
    them); adam, the tables after both steps against Adam (optax's
    update, f64) on whole tables from the start and the card's recorded
    gradients (TOL_VIDEO_TABLES: a step that moves only its window's rows
    leaves row 0 behind in the second step)."""
    import numpy as np

    from honerf_torch.fit.single import FitHyper, make_single_fit_loss, select_fit_kernels
    from honerf_torch.fit.video import VIDEO_FIT_LRS, init_video_state, make_video_fit_step
    from honerf_torch.render import dual as RD

    cpu = torch.device("cpu")
    fcfg = FitHyper.from_conf(fn.conf)._replace(fit_type=fit_type)
    rcfg = fn.rcfg._replace(perturb=0.0)
    windows = ([0, 1, 2, 3], [1, 2, 3, 4])
    ladder = RD.dual_hierarchical_z_vals
    fused, fine = select_fit_kernels(None, "full", fn.hand_sdf, dev)
    card_z = []
    rng = np.random.default_rng(5)
    start = {k: (v.detach().cpu().numpy() + 0.02 * rng.normal(size=tuple(v.shape))).astype(
        np.float32) for k, v in init_video_state(VIDEO_FRAMES, cpu)["tables"].items()}

    def cast(tree, d, dtype):
        if isinstance(tree, dict):
            return {k: cast(v, d, dtype) for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, d, dtype) for v in tree]
        return tree.detach().to(d, dtype).clone()

    def run(side, d, dtype):
        step = make_video_fit_step(cast(fn.nets, d, dtype), fn.hand_sdf, fn.hand_color,
                                   fn.obj_sdf, fn.obj_color, rcfg, fcfg, VIDEO_FRAMES,
                                   fused_ladder=fused and side == "card",
                                   fused_fine=None if side == "f64" else fine)
        tables = {k: torch.tensor(v, dtype=dtype, device=d).requires_grad_(True)
                  for k, v in start.items()}   # a copy: Adam steps them in place
        state = {"tables": tables, "opt": torch.optim.Adam(
            [{"params": [tables[k]], "lr": VIDEO_FIT_LRS[k]} for k in tables],
            betas=(0.9, 0.999), eps=1e-8)}
        replay = iter(card_z)

        def z_vals(*args):
            if side == "card":
                card_z.append(ladder(*args))
                return card_z[-1]
            return next(replay).to(cpu, dtype)

        RD.dual_hierarchical_z_vals = z_vals
        try:
            out = []
            for w in windows:
                batch = {k: (v.to(dtype) if v.is_floating_point() else v)
                         for k, v in video_check_batch(torch, w, d).items()}
                state, m = step(state, batch)
                tab = state["tables"]
                out.append(({k: float(v) for k, v in m.items()},
                            {k: tab[k].grad.detach().double().cpu() for k in tab},
                            {k: tab[k].detach().double().cpu().clone() for k in tab}))
        finally:
            RD.dual_hierarchical_z_vals = ladder
        return out

    card = run("card", dev, torch.float32)
    host = run("cpu", cpu, torch.float32)
    ref = run("f64", cpu, torch.float64)

    def rel(a, b):
        return float((a - b).norm() / max(float(b.norm()), 1e-12))

    steps = []
    for i, ((cm, cg, ct), (hm, hg, ht), (fm, fg, _)) in enumerate(zip(card, host, ref)):
        c0 = card[i - 1][2] if i else {k: torch.as_tensor(v, dtype=torch.float64)
                                       for k, v in start.items()}
        h0 = host[i - 1][2] if i else c0

        def ratio(c, h):
            return c / (FIT_FACTOR * h + TOL_FIT_F32)

        def dist(a, k):
            return abs(a[k] - fm[k]) / max(abs(fm[k]), 1e-6)

        steps.append(SimpleNamespace(
            f64={**{k: ratio(dist(cm, k), dist(hm, k)) for k in fm},
                 **{f"d{k}": ratio(rel(cg[k], fg[k]), rel(hg[k], fg[k])) for k in fg}},
            card_f64={k: rel(cg[k], fg[k]) for k in fg},
            cpu_f64={k: rel(hg[k], fg[k]) for k in fg},
            card_cpu={k: rel(cg[k], hg[k]) for k in hg},
            whole=rel(torch.cat([cg[k].flatten() for k in hg]),
                      torch.cat([hg[k].flatten() for k in hg])),
            updates={k: rel(ct[k] - c0[k], ht[k] - h0[k]) for k in ht}))

    # frames: the first window's frames one by one through the single fit
    # loss, at the card's ladder samples of the video step's first step
    single = make_single_fit_loss(fn.nets, fn.hand_sdf, fn.hand_color, fn.obj_sdf, fn.obj_color,
                                  rcfg, fcfg._replace(fit_type="12"), fused_ladder=fused,
                                  fused_fine=fine)
    batch = video_check_batch(torch, windows[0], dev)
    tables0 = {k: torch.tensor(v, device=dev) for k, v in start.items()}
    color, mask = [], []
    shared = ("cam_R", "cam_T", "focal", "principal", "obj_verts")
    for f, i in enumerate(windows[0]):
        pose = {"obj_rot6": tables0["obj_rot6"][i], "obj_trans": tables0["obj_trans"][i],
                "palm_rot6": tables0["palm_rot6"][i:i + 1],
                "palm_trans": tables0["palm_trans"][i:i + 1],
                "joint_angle": tables0["joint_angle"][i:i + 1],
                "palm_angle": tables0["palm_angle"][i:i + 1]}
        one = {k: (v if k in shared else v[f]) for k, v in batch.items()
               if k not in ("index", "anchor_enabled")}
        RD.dual_hierarchical_z_vals = lambda *a, z=card_z[f]: z
        try:
            with torch.no_grad():
                m = single(pose, one)[1]
        finally:
            RD.dual_hierarchical_z_vals = ladder
        color.append(float(m["color_loss"]))
        mask.append(float(m["mask_loss"]))
    frames = {"color": abs(card[0][0]["color_loss"] - np.mean(color)) / abs(np.mean(color)),
              "mask": abs(card[0][0]["mask_loss"] - np.mean(mask)) / abs(np.mean(mask))}

    # adam: optax's Adam in f64 on whole tables from the recorded gradients
    adam = {}
    for k, p0 in start.items():
        p, m, v = p0.astype(np.float64), 0.0, 0.0
        for t, (_, g, _) in enumerate(card, 1):
            g = g[k].numpy()
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            p = p - VIDEO_FIT_LRS[k] * (m / (1 - 0.9 ** t)) / (np.sqrt(v / (1 - 0.999 ** t))
                                                                 + 1e-8)
        got = card[-1][2][k].numpy() - p0
        adam[k] = float(np.linalg.norm(got - (p - p0)) / max(np.linalg.norm(p - p0), 1e-12))
    return SimpleNamespace(steps=steps, frames=frames, adam=adam, card=card, host=host, ref=ref)


def video_check_worst(r) -> float:
    """The largest ratio of a video_check_readings reading to its limit:
    the f64 rule's ratios against 1, whole and frames against
    TOL_FIT_HEAD_ON, the updates and adam against TOL_VIDEO_TABLES."""
    vals = [x for s in r.steps for x in s.f64.values()]
    vals += [s.whole / TOL_FIT_HEAD_ON for s in r.steps]
    vals += [x / TOL_FIT_HEAD_ON for x in r.frames.values()]
    vals += [x / TOL_VIDEO_TABLES for s in r.steps for x in s.updates.values()]
    vals += [x / TOL_VIDEO_TABLES for x in r.adam.values()]
    return max(float("inf") if x != x else x for x in vals)


def run_video_phases(torch, dev, phase, rows, failures, gen) -> None:
    """Phases 40-43: frame-batched fitting, video fitting and result
    extraction at the fit confs' full width on the synthetic VIDEO_FRAMES
    sequence (gen: start_video_sequence's process and data root), and one
    video step on the card against the CPU."""
    import pickle
    import shutil
    import tempfile

    import numpy as np

    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF
    from honerf_torch.ops import fused_hand as FH
    from honerf_torch.ops import fused_sdf as FS

    kernels = {"K1": FH.KERNEL, "K2": FF.KERNEL, "K3": FF.KERNEL_BWD, "K4": FS.KERNEL,
               "K5": FT.KERNEL_FWD, "K6": FT.KERNEL_BWD, "EMBED": FH.EMBED,
               "TFWD32": FT.TRUNK_FWD_F32, "TUCH32": FT.TRUNK_UCHAIN_F32,
               "TUT32": FT.TRUNK_UT_F32, "TDZ32": FT.TRUNK_DZ_F32, "TDW32": FT.TRUNK_DW_F32,
               "CFWD32": FF.COLOR_FWD_F32, "CBWD32": FF.COLOR_BWD_F32, "BWDREV": FF.BWDREV,
               "POSE": FF.POSE, "GEMM_F32": FH.GEMM_F32, "COLOR_DZ": FF.COLOR_DZ,
               "COLSUM": FT.COLSUM, "PACK": FT.PACK}
    fn = fit_nets(torch, dev)
    state = {}

    def zero():
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()

    def counts():
        torch.cuda.synchronize()
        return {name: k.launches for name, k in kernels.items()}

    def path_ok(label, launches):
        idle = [k for k in VIDEO_LAUNCHED if not launches[k]]
        extra = [k for k in VIDEO_IDLE if launches[k]]
        assert not idle and not extra, f"{label}: idle {idle}, stray {extra}: {launches}"

    def by_name(label, one):
        """One step's kernels by the profiler's names (counts > 0: a trace
        can lose launches), its host-clock ms and device busy
        (device_capture, trace_groups; the kernels by name into
        PROFILES[label])."""
        from collections import Counter

        evts, host_ms = device_capture(torch, one)
        names = Counter(e.name.split("(")[0] for e in evts)
        groups, busy = trace_groups(evts)
        busy = busy / 1e3 if evts else None
        if evts:
            PROFILES[label] = (groups, None)
        got = {g: sum(c for n, c in names.items() if any(x in n for x in ks))
               for g, ks in VIDEO_NAMES.items()}
        bad = sorted(n for n in names if any(x in n for x in VIDEO_STRAY))
        log(f"{label}: one step's kernels by name: {sum(names.values())} launches; "
            + ", ".join(f"{g} {c}" for g, c in got.items()) + f"; dW / split kernels "
            f"{bad or 'none'}; under the profiler {host_ms or 0:.1f} ms on the host clock, "
            f"device busy " + (f"{busy:.2f} ms" if busy else "not measured"))
        if busy:
            for name, (us, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0])[:10]:
                log(f"  {us / 1e3:8.2f} ms {100 * us / 1e3 / busy:5.1f}%  x{cnt:<5d} {name}")
        assert all(got.values()) and not bad, f"{label}: a kernel of the path is missing " \
                                               f"or a stray one ran: {got}, {bad}"
        return (host_ms, busy) if busy else None

    def timed(label, one, per_step):
        """ms per step over VIDEO_STEPS after VIDEO_WARMUP, on the host
        clock ending in synchronize()."""
        for i in range(VIDEO_WARMUP):
            one(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(VIDEO_STEPS):
            m = one(i)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / VIDEO_STEPS
        assert bool(torch.isfinite(m["loss"]).all()), f"{label}: a loss is not finite"
        zero()
        one(0)
        per = counts()
        log(f"{label}: {ms:.2f} ms a step ({VIDEO_STEPS} steps after {VIDEO_WARMUP} warm-up, "
            f"host clock, ray sampling and upload included; {per_step}); one step's launches "
            f"{ {k: v for k, v in per.items() if v} }")
        return ms, per

    def setup():
        proc, data = gen
        t0 = time.perf_counter()
        rc = proc.wait(timeout=600)
        assert rc == 0, f"the sequence's generator exited {rc}"
        ws = tempfile.mkdtemp(prefix="chip_smoke_video_")
        state["ws"] = ws
        state["confs"] = video_workspace(torch, fn, dev, ws, data)
        log(f"video workspace: the synthetic catch sequence ({VIDEO_FRAMES} frames, 8 views, "
            f"230x266; waited {time.perf_counter() - t0:.1f} s for its generator), checkpoints of "
            f"the fit confs' nets, '1''s poses at the initial estimates; cuts: train.epochs "
            f"{VIDEO_EPOCHS}, train.sub_iters {VIDEO_SUB_ITERS}, the batched '12' "
            f"train.iter_num {BATCH_ITERS}, the render conf at 8 views")

    def fit_batched():
        """fitting_single '12' with train.frames_per_batch = BATCH_G (frames
        0-3, then 4), then ms per batched step through the runner."""
        from honerf_torch.cli import fitting_single
        from honerf_torch.data.fit_datasets import load_fit_sequence
        from honerf_torch.fit.runner import SingleFitRunner
        from honerf_torch.fit.single import init_batched_fit_state

        ws, confs = state["ws"], state["confs"]
        zero()
        t0 = time.perf_counter()
        fitting_single.main(["--conf", confs["12"], "--case", "12_8view"])
        cli_s = time.perf_counter() - t0
        launches = counts()
        pose_dir = os.path.join(ws, "fit_res", "view_8", "12", "person1_bean", "seq0", "pose_12")
        names = sorted(os.listdir(pose_dir))
        poses = []
        for n in names:
            with open(os.path.join(pose_dir, n), "rb") as f:
                poses.append(pickle.load(f))
        finite = all(np.isfinite(v).all() and v.dtype == np.float32 for p in poses
                     for v in p.values())
        log(f"fit batched: the CLI '12' with frames_per_batch {BATCH_G} on {VIDEO_FRAMES} frames "
            f"in {cli_s:.1f} s ({BATCH_ITERS} iteration x 8 views a group); launches "
            f"{ {k: v for k, v in launches.items() if v} }; pickles {names}, f32 and finite "
            f"{finite}")
        assert names == [f"{i}.pickle" for i in range(VIDEO_FRAMES)] and finite
        path_ok("fit batched", launches)
        r = SingleFitRunner(confs["12"], "12_8view", device=dev)
        seq = load_fit_sequence(r.data_root, "person1_bean", "seq0", r.view_num, r.fit_type,
                                r.fit_res_root, r.exp_root, image_hw=(r.H, r.W))
        group = seq.frames[:BATCH_G]
        step = r.make_step(r.nets_for(seq), batched=True)
        consts = [r.frame_consts(seq, f) for f in group]
        stacked = {k: torch.stack([c[k] for c in consts]) for k in consts[0]}
        st = init_batched_fit_state(BATCH_G, dev)
        gen_ = torch.Generator(device=dev).manual_seed(0)

        def one(i=0):
            rows_ = [r.view_batch(f, i % 8, r.fcfg.batch_size) for f in group]
            batch = dict(stacked, **{k: r._tensor(np.stack([x[k] for x in rows_]))
                                     for k in rows_[0]})
            return step(st, batch, gen_)[1]

        ms, per = timed(f"fit batched (G = {BATCH_G}, {r.fcfg.batch_size} rays a frame)", one,
                        f"{BATCH_G} frames a step")
        prof = by_name("one batched '12' fit step (G = 4)", one)
        state["batched"] = (ms, prof, per)
        for k in ("K2", "K3"):
            rows[k] = dict(rows.get(k, {}), batched_launches=per[k])

    def video():
        """fitting_video '123' and '1234' through the CLI's main, then ms
        per window step through the runner."""
        from honerf_torch.cli import fitting_video
        from honerf_torch.data.fit_datasets import load_fit_sequence
        from honerf_torch.fit.runner import VideoFitRunner
        from honerf_torch.fit.video import init_video_state

        ws, confs = state["ws"], state["confs"]
        for ft in ("123", "1234"):
            zero()
            t0 = time.perf_counter()
            fitting_video.main(["--conf", confs[ft], "--case", f"{ft}_8view_id0"])
            cli_s = time.perf_counter() - t0
            launches = counts()
            base = os.path.join(ws, "fit_res", "view_8", ft, "person1_bean", "seq0")
            dirs = sorted(os.listdir(base))
            pickles = [sorted(os.listdir(os.path.join(base, d))) for d in dirs]
            log(f"video {ft}: the CLI in {cli_s:.1f} s ({VIDEO_EPOCHS} epochs x 2 windows x "
                f"{VIDEO_SUB_ITERS} x 8 views steps); launches "
                f"{ {k: v for k, v in launches.items() if v} }; {dirs}: {pickles[0]}")
            assert dirs == [f"pose_{e}" for e in range(VIDEO_EPOCHS)] and all(
                p == [f"{i}.pickle" for i in range(VIDEO_FRAMES)] for p in pickles)
            path_ok(f"video {ft}", launches)
            r = VideoFitRunner(confs[ft], f"{ft}_8view_id0", device=dev)
            seq = load_fit_sequence(r.data_root, "person1_bean", "seq0", r.view_num, r.fit_type,
                                    r.fit_res_root, r.exp_root, image_hw=(r.H, r.W))
            step = r.make_step(r.nets_for(seq), len(seq))
            st = init_video_state(len(seq), dev)
            frames = seq.frames[:4]
            consts = r.window_consts(seq, frames, range(4))
            gen_ = torch.Generator(device=dev).manual_seed(0)
            rays = video_rays(confs[ft])

            def one(i=0):
                batch = dict(consts, **r.window_view_batch(frames, i % 8, rays))
                batch["anchor_enabled"] = r._tensor(1.0)
                return step(st, batch, gen_)[1]

            ms, per = timed(f"video {ft} (4 frames x {rays} rays a window step)", one,
                            "a window step")
            prof = by_name(f"one video '{ft}' window step", one) if ft == "123" else None
            state[f"video_{ft}"] = (ms, prof, per)
            if ft == "123":
                for k in ("K1", "K2", "K3"):
                    rows[k] = dict(rows.get(k, {}), video_launches=per[k])

    def get_res():
        """get_res '12' (meshes, inner ids), '123' (inner ids, the CLI) and
        one --render frame: K1 and K4 launched, ms of each part; the
        first frame's grids through K1 and K4 against their plain
        versions."""
        from honerf_torch.cli import get_res as get_res_cli
        from honerf_torch.data import fit_datasets as FD
        from honerf_torch.data.fit_datasets import load_fit_sequence
        from honerf_torch.extract import bounds_from_points, evaluate_sdf_grid
        from honerf_torch.fit.runner import GetResRunner
        from honerf_torch.hand import bone_transforms_from_mano_joints

        ws, confs = state["ws"], state["confs"]
        zero()
        r = GetResRunner(confs["get_res_12"], "get_res_12", device=dev)
        r.fitting()
        launches = counts()
        base = os.path.join(ws, "fit_res", "analys_res", "view_8", "12", "person1_bean", "seq0")
        meshes = sorted(os.listdir(os.path.join(base, "mesh_12")))
        inner = sorted(os.listdir(os.path.join(base, "inner_12")))
        assert len(meshes) == 2 * VIDEO_FRAMES and len(inner) == VIDEO_FRAMES, (meshes, inner)
        assert all(launches[k] for k in GET_RES_LAUNCHED["meshes"]) and not any(
            launches[k] for k in GET_RES_IDLE), f"the meshes' kernels: {launches}"
        t = r.timings
        parts = ("hand_grid_s", "hand_mc_s", "hand_ply_s", "obj_grid_s", "obj_mc_s", "obj_ply_s",
                 "inner_s")
        mean = {p: 1e3 * float(np.mean([x[p] for x in t])) for p in parts}
        log(f"get_res 12: {VIDEO_FRAMES} frames at {GET_RES_MESH}^3 in "
            f"{sum(sum(x[p] for p in parts) for x in t):.2f} s; a frame's ms: "
            + ", ".join(f"{p[:-2]} {v:.2f}" for p, v in mean.items())
            + f"; vertices hand {[x['hand_verts'] for x in t]}, obj {[x['obj_verts'] for x in t]}"
            f"; launches K1 {launches['K1']}, K4 {launches['K4']}")
        zero()
        get_res_cli.main(["--conf", confs["get_res_123"], "--case", "get_res_123"])
        n123 = counts()
        inner123 = sorted(os.listdir(os.path.join(
            ws, "fit_res", "analys_res", "view_8", "123", "person1_bean", "seq0", "inner_123")))
        log(f"get_res 123 (the CLI, from pose_{VIDEO_EPOCHS - 1}): inner ids {inner123}; K1 "
            f"{n123['K1']} launches")
        assert len(inner123) == VIDEO_FRAMES and all(
            n123[k] for k in GET_RES_LAUNCHED["meshes"][:1])
        # one --render frame: frame 0's '12' pose alone under fit_res_render
        src = os.path.join(ws, "fit_res", "view_8", "12", "person1_bean", "seq0", "pose_12")
        dst = os.path.join(ws, "fit_res_render", "view_8", "12", "person1_bean", "seq0",
                           "pose_12")
        os.makedirs(dst)
        shutil.copy(os.path.join(src, "0.pickle"), dst)
        zero()
        rr = GetResRunner(confs["render"], "render_res", render=True, device=dev)
        # one test view: the synthetic sequence's cameras include all five
        # of RENDER_TEST_VIEWS
        views = FD.RENDER_TEST_VIEWS
        FD.RENDER_TEST_VIEWS = views[:1]
        try:
            rr.fitting()
            seq = load_fit_sequence(r.data_root, "person1_bean", "seq0", "8", "1",
                                    r.fit_res_root, r.exp_root, image_hw=(r.H, r.W),
                                    load_test_views=True)
        finally:
            FD.RENDER_TEST_VIEWS = views
        nr = counts()
        rdir = os.path.join(ws, "fit_res_render", "analys_res", "view_8", "12", "person1_bean",
                            "seq0", "render_12")
        imgs = sorted(os.listdir(rdir))
        img = read_png(os.path.join(rdir, imgs[0]))
        render_ms = 1e3 * rr.timings[0]["render_s"]
        log(f"get_res render: {imgs} ({img.shape}, {int((img.sum(-1) > 0).sum())} non-black "
            f"pixels) in {render_ms:.1f} ms; launches "
            f"{ {k: v for k, v in nr.items() if v} }")
        assert len(imgs) == 1 and img.shape == (rr.H, rr.W, 3) and img.any()
        assert all(nr[k] for k in GET_RES_LAUNCHED["render"]) and not any(
            nr[k] for k in GET_RES_IDLE), f"the render's kernels: {nr}"
        frame_ms = sum(mean.values()) + render_ms
        # the first frame's grids: K1 and K4 against their plain versions
        with open(os.path.join(src, "0.pickle"), "rb") as f:
            pose = pickle.load(f)
        hand, obj = r.sdf_fns(r.nets_for(seq))
        t_pose = torch.as_tensor(seq.t_pose_21, device=dev)
        with torch.no_grad():
            bt = bone_transforms_from_mano_joints(
                torch.as_tensor(pose["pred_joint3d"], device=dev)[None])[0]
        rt = torch.as_tensor(pose["pred_Ro"], device=dev)
        tt = torch.as_tensor(pose["pred_To"], device=dev)
        rot_t, off, cut = FH.pack_hand_pose(bt, t_pose)
        checks = []
        for part, k_fn, p_fn, pts in (
                ("hand", lambda p: hand(p, bt, t_pose),
                 lambda p: FH.fused_hand_sdf_plain(p, rot_t, off, cut, hand.ws, hand.bs,
                                                   hand.meta), pose["pred_joint3d"]),
                ("obj", lambda p: obj((p - tt) @ rt),
                 lambda p: FS.fused_obj_sdf_plain(((p - tt) @ rt).contiguous(), obj.ws, obj.bs,
                                                  obj.meta), pose["pred_To"][None])):
            lo, hi = bounds_from_points(pts, 0.08)
            gk, gp = (evaluate_sdf_grid(f, lo, hi, GET_RES_MESH, device=dev)
                      for f in (k_fn, p_fn))
            ok, text = mesh_rule(torch, dev, gk, gp, bf16=part == "hand")
            checks.append(ok)
            log(f"get_res: frame 0's {GET_RES_MESH}^3 {part} grid through "
                f"{'K1' if part == 'hand' else 'K4'} against its plain version: {text}")
        # a frame's device busy: its meshes and inner ids, then its render
        nets = r.nets_for(seq)
        prof_m = device_profile(torch, "one get_res frame's meshes and inner ids", lambda: (
            r.process_frame(seq, seq.frames[0], pose, os.path.join(ws, "prof"), nets)))
        prof_r = device_profile(torch, "one get_res frame's 230x266 dual render", lambda: (
            rr.process_frame(seq, seq.frames[0], pose, os.path.join(ws, "prof_r"), nets)))
        state["get_res"] = (frame_ms, prof_m, prof_r, mean, render_ms)
        rows["K1"] = dict(rows.get("K1", {}), get_res_launches=launches["K1"] // VIDEO_FRAMES)
        rows["K4"] = dict(rows.get("K4", {}), get_res_launches=launches["K4"] // VIDEO_FRAMES)
        log(f"get_res: ms a frame {frame_ms:.1f} (meshes, inner ids, one render)")
        assert all(checks), "a get_res grid disagrees with its plain version"

    def video_check():
        r = video_check_readings(torch, fn, dev)
        for i, s in enumerate(r.steps):
            log(f"video check, step {i + 1} (window {[0, 1, 2, 3] if i == 0 else [1, 2, 3, 4]}, "
                f"{video_rays()} rays a frame): "
                "gradients' distance from the CPU's f64 step, card / CPU f32: " + ", ".join(
                    f"{k} {s.card_f64[k]:.2e}/{s.cpu_f64[k]:.2e}" for k in s.card_f64)
                + f"; the f64 rule's worst {max(s.f64.values()):.3f} (card <= {FIT_FACTOR:g} x "
                f"CPU + {TOL_FIT_F32:g}); card vs CPU f32: gradients " + ", ".join(
                    f"{k} {v:.2e}" for k, v in s.card_cpu.items())
                + f", all six as one {s.whole:.2e} (tol {TOL_FIT_HEAD_ON:g}); updates "
                + ", ".join(f"{k} {v:.2e}" for k, v in s.updates.items())
                + f" (tol {TOL_VIDEO_TABLES:g})")
        log("video check: the card's step against its frames one by one (single fit loss): "
            + ", ".join(f"{k} {v:.2e}" for k, v in r.frames.items())
            + "; the tables after two steps against f64 Adam on whole tables: "
            + ", ".join(f"{k} {v:.2e}" for k, v in r.adam.items()))
        log("video check: card metrics " + ", ".join(
            f"{k} {v:.6g}" for k, v in r.card[0][0].items()))
        worst = video_check_worst(r)
        log(f"video check: worst {worst:.3f} of its limit")
        assert worst <= 1.0, "the card's video step disagrees"

    try:
        phase("video setup", setup)
        if "video setup" in failures:
            failures += ["fit batched", "video", "get_res"]
        else:
            phase("fit batched", fit_batched)
            phase("video", video)
            if "fit batched" in failures or "video" in failures:
                failures.append("get_res")
            else:
                phase("get_res", get_res)
        phase("video check", video_check)
        gpu = gpu_line()
        for key, label in (("batched", f"a batched '12' step (G = {BATCH_G})"),
                           ("video_123", "a '123' window step"),
                           ("video_1234", "a '1234' window step")):
            if key in state:
                ms, prof, _ = state[key]
                busy = f"{prof[1]:.2f} ms" if prof else "not measured"
                log(f"video summary: {label}: {ms:.2f} ms, device busy {busy}; {gpu}")
        if "get_res" in state:
            frame_ms, pm, pr, _, _ = state["get_res"]
            busy = (f"{pm[1]:.2f} + {pr[1]:.2f} ms" if pm and pr else "not measured")
            log(f"video summary: a get_res frame: {frame_ms:.1f} ms, device busy {busy}; {gpu}")
    finally:
        if state.get("ws"):
            shutil.rmtree(state["ws"], ignore_errors=True)


def run_f32_train_phases(torch, dev, phase, rows, failures, view, rays, request_pts) -> None:
    """Phases 21-28, the hand's offline stage with the flagship conf's own
    f32 trunks (as written): the f32 GEMMs alone, K2 f32 at a request's
    points, K3 f32 with weight gradients, K2/K3 f32 without the color net
    and K5/K6 f32 against their plain versions at a step's shapes, the
    train step under each kernel mode and the autograd field, one step per
    mode on the card against the CPU, and a 'full' request.  `view` is the
    serve phase's camera and pose, `rays` the NDC rays of one request,
    `request_pts` (pts, rotT, off, cut) K2's points of one request."""
    from honerf_torch.models.fields import pack_fine_color
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF
    from honerf_torch.ops import fused_hand as FH
    from honerf_torch.train.offline import (
        init_train_state,
        make_hand_eval_render,
        make_hand_train_step,
        select_fine_pass,
    )

    fs = flagship(torch, dev, "f32")
    sdf_cfg, color_cfg = fs.sdf, fs.color
    E, d_out = sdf_cfg.input_width, sdf_cfg.d_out
    ttcfg = train_hyper(fs)
    kernels = {"K1": FH.KERNEL, "K2": FF.KERNEL, "K3": FF.KERNEL_BWD, "K5": FT.KERNEL_FWD,
               "K6": FT.KERNEL_BWD, "GEMM_F32": FH.GEMM_F32, "GEMM_TN_F32": FH.GEMM_TN_F32,
               "GEMM": FH.GEMM, "GEMM_TN": FH.GEMM_TN, "EMBED": FH.EMBED, "COLSUM": FT.COLSUM,
               "UCHAIN": FT.UCHAIN, "BWDREV": FF.BWDREV, "PACK": FT.PACK, "POSE": FF.POSE,
               "TFWD32": FT.TRUNK_FWD_F32, "TUCH32": FT.TRUNK_UCHAIN_F32,
               "TUT32": FT.TRUNK_UT_F32, "TDZ32": FT.TRUNK_DZ_F32, "TDW32": FT.TRUNK_DW_F32,
               "CFWD32": FF.COLOR_FWD_F32, "CBWD32": FF.COLOR_BWD_F32, "COLOR_DZ": FF.COLOR_DZ}
    log(f"f32 phases: {os.path.relpath(CONF, ROOT)} as written, trunks {sdf_cfg.trunk_dtype}; "
        "select_fine_pass on the card: " + ", ".join(
            f"{m} -> {select_fine_pass(ttcfg._replace(fused_fine=m), sdf_cfg, dev)}"
            for m in (None, "full", "full_nocolor", "pallas")))
    inputs = {}

    def step_inputs(mode):
        if mode not in inputs:
            inputs[mode] = step_bwd_inputs(torch, fs, dev, mode=mode)
        return inputs[mode]

    def l2(a, b):
        return float((a - b).norm()) / max(float(b.norm()), 1e-30)

    def f32_names(fn):
        """fn's device kernels by name: (f32 GEMMs, the fused f32 backward
        pair, the weight gradients' launch, the sequence it replaced (f32 TN
        GEMMs, reduce_partials_kernel, colsum_partial_kernel), bf16 GEMMs,
        bf16 TN GEMMs, all launches, the fused color pair, color_dz_kernel)."""
        names = device_kernel_names(torch, fn)

        def count(*keys):
            return sum(c for k, c in names.items() if "honerf" in k and any(x in k for x in keys))

        return (count("gemm_f32_kernel"),
                count("hand_trunk_ut_f32_kernel", "hand_trunk_dz_f32_kernel"),
                count("trunk_dw_f32_kernel"),
                count("gemm_tn_f32_kernel", "reduce_partials_kernel", "colsum_partial_kernel"),
                count("gemm_kernel"), count("gemm_tn_kernel"), sum(names.values()),
                count("color_fwd_f32_kernel", "color_bwd_f32_kernel"), count("color_dz_kernel"))

    def bwd_report(label, mode, args, flops, n_bytes, key, names_fn):
        """The f32 rule with and without dW, a second run's bits, the
        kernel names, times; rows[key]'s f32 numbers; returns the
        outputs."""
        n = args[0].shape[0]
        mod, name, plain, _, _ = bwd_entry(mode)
        got, checks, dropped = f32_bwd_check(torch, args, mode)
        _, frozen_checks, _ = f32_bwd_check(torch, args, mode, want_dw=False)
        for c in checks:
            log(f"{label} {c.text}")
        log(f"{label} frozen (no weight gradient): " + "; ".join(c.text for c in frozen_checks))
        again = getattr(mod, name)(*args)
        first = getattr(mod, name)(*args)
        same = all(torch.equal(x, y) for (_, x), (_, y) in zip(bwd_entry(mode)[3](again),
                                                               bwd_entry(mode)[3](first)))
        f32_g, bwd32, dw32, tn_f32, bf16_g, bf16_tn, total, color32, cdz_g = names_fn(
            lambda: getattr(mod, name)(*args))
        ms = cuda_ms(torch, lambda: getattr(mod, name)(*args), 5)
        frozen_ms = cuda_ms(torch, lambda: getattr(mod, name)(*args, want_dw=False), 5)
        plain_ms = cuda_ms(torch, lambda: plain(*args), 2)
        b_ms, b_by = bound(flops, n_bytes, PEAK_F32_3XTF32_FLOPS)
        log(f"{label}: {n} pts ({-(-n // FT.chunk_size(n, 'f32', FF.BWD_CHUNK))} passes"
            + (f"; dcolor zero at {dropped} points within {FF.RELU_MARGIN:g} of a relu kink"
               if mode == "full" else "") + f"); a second run gives the same bits: {same}; "
            f"kernels by name: {total} launches, f32 GEMMs {f32_g}, the fused f32 backward pair "
            f"{bwd32}, the fused dW launch {dw32}, f32 TN GEMMs, reduces and column sums "
            f"{tn_f32}, bf16 GEMMs {bf16_g}, bf16 TN GEMMs {bf16_tn}, the fused color pair "
            f"{color32}, color_dz_kernel {cdz_g}; kernel {ms:.3f} ms, frozen "
            f"{frozen_ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{flops / 1e12:.4f} TFLOP, {flops / n / 1e6:.3f} MFLOP/pt, "
            f"{flops / ms / 1e9:.1f} TFLOP/s)")
        rows[key[0]] = dict(rows.get(key[0], {}), **{f"{key[1]}ms": ms,
                                                     f"{key[1]}plain_ms": plain_ms,
                                                     f"{key[1]}bound_ms": b_ms})
        if not all(c.ok for c in checks + frozen_checks) or not same:
            raise AssertionError(f"{label} disagrees with its plain version")
        if (not (bwd32 and dw32) or tn_f32 or bf16_g or bf16_tn or f32_g or cdz_g
                or bool(color32) != (mode == "full")):
            raise AssertionError(f"{label}: the fused f32 backward pair and dW launch (and with "
                                 "the color net its fused pair), and no f32 or bf16 GEMM, f32 "
                                 "TN GEMM, reduce, column sum or color_dz_kernel, not shown")
        return got

    def f32_gemms():
        """Both f32 GEMMs alone at an f32 pass's shapes against f64
        (f32_gemm_readings), timed beside torch.matmul in f32."""
        readings = f32_gemm_readings(torch, dev)
        for r in readings:
            log(f"{r.what}, M {F32_GEMM_M}: |kernel - f64| / |f64| in L2 {r.l2:.2e} (tol "
                f"{TOL_GEMM_F32_L2:g}; one TF32 product {r.tf32_l2:.2e}), max |err| "
                f"{r.max_abs:.2e}; a rerun gives the same bits: {r.same}; kernel {r.ms:.4f} ms "
                f"({r.flops / r.ms / 1e9:.1f} TFLOP/s), torch.matmul f32 {r.lib_ms:.4f} ms, "
                f"bound {r.bound_ms:.4f} ms ({r.bound_by}, 3xTF32; FP32 on the CUDA cores "
                f"{r.flops / PEAK_F32_FLOPS * 1e3:.4f} ms){'' if r.ok else ' FAIL'}")
        for key, gemm in (("GEMM_F32", FH.GEMM_F32), ("GEMM_TN_F32", FH.GEMM_TN_F32)):
            mine = [r for r in readings if r.what.split()[0] + "_kernel" == gemm.name]
            ms, lib_ms = sum(r.ms for r in mine), sum(r.lib_ms for r in mine)
            b_ms = sum(r.bound_ms for r in mine)
            log(f"{gemm.name}, the {len(mine)} shapes: kernel {ms:.4f} ms, torch.matmul f32 "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms, "
                f"{sum(r.flops for r in mine) / ms / 1e9:.1f} TFLOP/s")
            # the plain versions' products are the f32 matmul itself
            rows[key] = dict(rows.get(key, {}), name=gemm.name, route="cuda", source=gemm.source,
                             replaces=gemm.replaces, max_abs_err=max(r.max_abs for r in mine),
                             ms=ms, plain_ms=lib_ms, bound_ms=b_ms,
                             bound_by=mine[0].bound_by, library_ms=lib_ms)
        if not all(r.ok for r in readings):
            raise AssertionError("an f32 GEMM disagrees with the f64 product or its rerun")

    def kernel_k2_f32_request():
        """K2 f32 at the points of one 4096-ray request (128 samples a ray,
        several passes of its chunk loop) against its plain version, under
        the f32 rule (TOL_F32 of the range, median and max)."""
        pts, rotT, off, cut = request_pts
        pack = pack_fine_color(fs.params, sdf_cfg, color_cfg)
        args = (pts, rotT, off, cut, pack)
        n = pts.shape[0]
        got = FF.hand_fine_color_fwd(*args)
        want = FF.hand_fine_color_plain(*args)
        torch.cuda.synchronize()
        checks = [compare(torch, what, a, b, TOL_F32, TOL_F32)
                  for what, a, b in zip(("sdf", "g", "color"), got, want)]
        ms = cuda_ms(torch, lambda: FF.hand_fine_color_fwd(*args), 3)
        plain_ms = cuda_ms(torch, lambda: FF.hand_fine_color_plain(*args), 1)
        flops = k2_flops(sdf_cfg, color_cfg, n)
        n_bytes = (nbytes([pts, rotT, off, cut, *pack.ws, *pack.bs, *pack.cws, *pack.cbs])
                   + 28 * n)
        b_ms, b_by = bound(flops, n_bytes, PEAK_F32_3XTF32_FLOPS)
        log(f"K2 f32 hand_fine_color_fwd, one request: {n} pts "
            f"({-(-n // FT.chunk_size(n, 'f32', FF.CHUNK))} passes); "
            f"{'; '.join(c[2] for c in checks)}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}, {flops / ms / 1e9:.1f} TFLOP/s)")
        rows["K2"] = dict(rows.get("K2", {}), f32_request_ms=ms, f32_request_plain_ms=plain_ms,
                          f32_request_bound_ms=b_ms)
        if not all(c[0] for c in checks):
            raise AssertionError("K2 f32 disagrees with its plain version at a request")

    def kernel_k3_f32_dw():
        """K3 f32 with dW on what one flagship f32 'full' step hands it
        (56,448 points, the loss's cotangents), TF32 off; the last color
        layer's dW read three ways (C4)."""
        args = step_inputs("full")
        pack = args[4]
        n = args[0].shape[0]
        weights = [*pack.ws, *pack.bs, *pack.cws, *pack.cbs]
        n_bytes = (nbytes([*args[:4], *args[5:], *weights]) + 12 * n
                   + 4 * sum(w.numel() for w in weights) + 4 * 9 * 128)
        bwd_report("K3 f32", "full", args, k3_flops(sdf_cfg, color_cfg, n), n_bytes,
                         ("K3", "f32_dw_"), f32_names)
        g = FF.hand_fine_color_fwd(*args[:5])[1]
        own = FF.hand_fine_color_plain_bwd(*args)
        shared = FF.hand_fine_color_plain_bwd(*args, g_color=g)
        full = FF.hand_fine_color_bwd(*args)
        last = len(full.dcws) - 1
        worst = max((l2(a, b), w) for (w, a), (_, b) in zip(k3_outputs(full), k3_outputs(own)))
        log(f"K3 f32 (C4): the last color layer's dW, |kernel - plain| / |plain| in L2, on the "
            f"step's cotangents: {l2(full.dcws[last], own.dcws[last]):.2e} against the plain "
            f"version with its own g, {l2(full.dcws[last], shared.dcws[last]):.2e} at the "
            f"kernel's g (the rule's reading, with dcolor zero near the kinks: dcws[{last}] "
            f"above); every output against its own g: worst {worst[0]:.2e} ({worst[1]})")

    def kernel_nocolor_f32():
        """K2 f32 without the color net at a flagship f32 'full_nocolor'
        step's points (out, g, e within TOL_F32 of the range, median and
        max), K3 f32 without it on that step's inputs, with and without
        dW."""
        args = step_inputs("full_nocolor")
        pack = args[4]
        n = args[0].shape[0]
        fargs = args[:5]
        got = FF.hand_fine_color_fwd(*fargs)
        want = FF.hand_fine_color_plain(*fargs)
        torch.cuda.synchronize()
        checks = [compare(torch, what, a, b, TOL_F32, TOL_F32)
                  for what, a, b in zip(("out", "g", "e"), got, want)]
        ms = cuda_ms(torch, lambda: FF.hand_fine_color_fwd(*fargs), 5)
        plain_ms = cuda_ms(torch, lambda: FF.hand_fine_color_plain(*fargs), 2)
        n_bytes = 12 * n + 4 * (d_out + 3 + E) * n + nbytes([*fargs[1:4], *pack.ws, *pack.bs])
        flops = k5_flops(sdf_cfg, n)
        b_ms, b_by = bound(flops, n_bytes, PEAK_F32_3XTF32_FLOPS)
        log(f"K2 f32 no-color hand_fine_color_fwd: {n} pts "
            f"({-(-n // FT.chunk_size(n, 'f32', FF.CHUNK))} passes); "
            f"{'; '.join(c[2] for c in checks)}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}, {flops / n / 1e6:.3f} MFLOP/pt, "
            f"{flops / ms / 1e9:.1f} TFLOP/s)")
        rows["K2"] = dict(rows.get("K2", {}), f32_nocolor_ms=ms, f32_nocolor_plain_ms=plain_ms,
                          f32_nocolor_bound_ms=b_ms)
        weights = [*pack.ws, *pack.bs]
        n_bytes = (nbytes([*args[:4], *args[5:], *weights]) + 12 * n
                   + 4 * sum(w.numel() for w in weights) + 4 * 9 * 128)
        bwd_report("K3 f32 no-color", "full_nocolor", args, k3_nocolor_flops(sdf_cfg, n),
                   n_bytes, ("K3", "f32_nocolor_"), f32_names)
        if not all(c[0] for c in checks):
            raise AssertionError("K2 f32 without the color net disagrees with its plain version")

    def kernel_k5k6_f32():
        """K5 f32 (out, u within TOL_F32 of the range) and K6 f32, with and
        without dW, on what one flagship f32 'pallas' step hands them."""
        args = step_inputs("pallas")
        e, tpack = args[0], args[1]
        n = e.shape[0]
        got = FT.hand_trunk_sdf_u_fwd(e, tpack)
        want = FT.hand_trunk_sdf_u_plain(e, tpack)
        torch.cuda.synchronize()
        checks = [compare(torch, what, a, b, TOL_F32, TOL_F32)
                  for what, a, b in zip(("out", "u"), got, want)]
        ms = cuda_ms(torch, lambda: FT.hand_trunk_sdf_u_fwd(e, tpack), 5)
        plain_ms = cuda_ms(torch, lambda: FT.hand_trunk_sdf_u_plain(e, tpack), 2)
        weights = [*tpack.ws, *tpack.bs]
        flops = k5_flops(sdf_cfg, n)
        b_ms, b_by = bound(flops, 4 * (2 * E + d_out) * n + nbytes(weights),
                           PEAK_F32_3XTF32_FLOPS)
        # K5 f32's trunk is the fused f32 pair, two launches a pass: no GEMM
        # of either type.  Read from the call's CUDA graph: a profiler
        # capture of this call lost some or all of the pair's launches on
        # an H100 in three of four runs of this script.
        passes = -(-n // FT.chunk_size(n, 'f32', FT.CHUNK))
        nodes = graph_kernel_nodes(torch, lambda: FT.hand_trunk_sdf_u_fwd(e, tpack))
        pair, gemms_k5 = (sum(any(x in k for x in keys) for k in nodes)
                          for keys in (("hand_trunk_fwd_f32_kernel", "hand_uchain_f32_kernel"),
                                       ("gemm_f32_kernel", "gemm_kernel")))
        log(f"K5 f32 hand_trunk_sdf_u_fwd: {n} pts ({passes} passes); "
            f"{'; '.join(c[2] for c in checks)}; its CUDA graph: {len(nodes)} nodes, the fused "
            f"f32 pair {pair}, GEMMs {gemms_k5}; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}, "
            f"{flops / n / 1e6:.3f} MFLOP/pt, {flops / ms / 1e9:.1f} TFLOP/s)")
        rows["K5"] = dict(rows.get("K5", {}), f32_ms=ms, f32_plain_ms=plain_ms, f32_bound_ms=b_ms)
        n_bytes = (4 * (3 * E + d_out) * n + nbytes(weights)
                   + 4 * sum(w.numel() for w in weights))
        bwd_report("K6 f32", "pallas", args, k6_flops(sdf_cfg, n), n_bytes, ("K6", "f32_"),
                   f32_names)
        if not all(c[0] for c in checks) or pair != 2 * passes or gemms_k5:
            raise AssertionError("K5 f32 disagrees with its plain version or ran a GEMM")

    gemms = ("TDW32", "TFWD32", "TUCH32", "TUT32", "TDZ32")
    # the embedding kernel with K2 / K3 (K5 / K6 take e from torch); the f32
    # trunk's forward and u-chain as the fused pair, its backward as the
    # fused backward pair, every dW and db (the color net's too) in one
    # launch a pass, no TN GEMM or column sum, no u-chain seed; the color
    # net as its fused pair: no gemm_f32_kernel on any path
    expect = {"full": ("K2", "K3", "EMBED", "BWDREV", "POSE", "CFWD32", "CBWD32") + gemms,
              "full_nocolor": ("K2", "K3", "EMBED", "BWDREV", "POSE") + gemms,
              "pallas": ("K5", "K6", "PACK") + gemms, None: ()}
    # an f32 step's K3 / K5 / K6 take its 56,448 fine points in two passes:
    # two pose sums a K3, two packs a K5 and a K6, the fused pair once a
    # pass of K2 / K3 / K5 / K6, the backward pair once a pass of K3 / K6;
    # the color net's forward once a pass of K2 and of K3's recompute, its
    # transpose once a pass of K3; no gemm_f32_kernel or color_dz_kernel
    # (TRUNK32_LAUNCHES)
    pair = {"TFWD32": 4, "TUCH32": 4, "TUT32": 2, "TDZ32": 2, "UCHAIN": 0, "TDW32": 2,
            "GEMM_TN_F32": 0, "COLSUM": 0, "GEMM_F32": 0, "COLOR_DZ": 0}
    no_color = {"CFWD32": 0, "CBWD32": 0}
    per_step = {"full": {"POSE": 2, "CFWD32": 4, "CBWD32": 2, **pair},
                "full_nocolor": {"POSE": 2, **no_color, **pair},
                "pallas": {"PACK": 4, **no_color, **pair}, None: {}}

    f32_calls = {}   # the per-point calls of an f32 'full' and 'pallas' step

    def train_f32():
        """The flagship train step with the conf's f32 trunks under each
        kernel mode and the autograd field (None): TRAIN_WARMUP +
        TRAIN_STEPS steps, the launch counts zeroed just before and read
        just after; one more step's kernels by name."""
        batch = train_batch(torch, TRAIN_RAYS, dev)
        bad = []
        for mode, want in expect.items():
            label = f"train f32 {mode or 'autograd'}"
            tcfg_m = ttcfg._replace(fused_fine=mode)
            tparams = train_params(fs, dev)
            state = init_train_state(tparams, tcfg_m)
            step = make_hand_train_step(sdf_cfg, color_cfg, fs.rcfg, tcfg_m)
            gen = torch.Generator(device=dev).manual_seed(0)
            se3_before = tparams["se3_refine"].detach().clone()
            for k in kernels.values():
                k.launches = 0
            torch.cuda.reset_peak_memory_stats()
            metrics = []
            for _ in range(TRAIN_WARMUP):
                state, m = step(state, batch, gen)
                metrics.append(m)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                state, m = step(state, batch, gen)
                metrics.append(m)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {name: k.launches for name, k in kernels.items()}
            loss = torch.stack([m["loss"] for m in metrics])
            gnorm = torch.stack([m["grad_norm"] for m in metrics])
            finite = bool(torch.isfinite(loss).all()) and bool(torch.isfinite(gnorm).all())
            moved = float((tparams["se3_refine"].detach() - se3_before).abs().max())
            f32_g, bwd32, dw32, tn_f32, bf16_g, bf16_tn, total, color32, cdz_g = f32_names(
                lambda: step(state, batch, gen))
            log(f"{label}: {TRAIN_STEPS} steps of {TRAIN_RAYS} rays: "
                f"{dt * 1e3 / TRAIN_STEPS:.2f} ms/step, {TRAIN_RAYS * TRAIN_STEPS / dt:.1f} "
                f"rays/s (host clock, after {TRAIN_WARMUP} warm-up steps); peak device memory "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}; "
                f"one step's kernels by name: {total} launches, f32 GEMMs {f32_g}, the fused f32 "
                f"backward pair {bwd32}, the fused dW launch {dw32}, f32 TN GEMMs, reduces and "
                f"column sums {tn_f32}, bf16 GEMMs {bf16_g}, bf16 TN GEMMs {bf16_tn}, the fused "
                f"color pair {color32}, color_dz_kernel {cdz_g}")
            log(f"{label}: loss first {float(loss[0]):.4f} last {float(loss[-1]):.4f}; grad_norm "
                f"first {float(gnorm[0]):.4f} last {float(gnorm[-1]):.4f}; se3_refine moved by "
                f"up to {moved:.3e}")
            if mode in ("full", "pallas"):
                device_profile(torch, f"one {label} step of {TRAIN_RAYS} rays",
                               lambda: step(state, batch, gen), points=TRAIN_FINE_PTS // 2)
            if mode in ("full", "pallas"):
                rec = record_perpoint_calls(lambda: step(state, batch, gen))
                f32_calls[mode] = rec
                label_m = f"f32 '{mode}' step"
                TRUNK32_CALLS[label_m] = record_trunk_calls(lambda: step(state, batch, gen))
                TRUNK_BWD32_CALLS[label_m] = TRUNK32_CALLS[label_m]
                TRUNK32_COUNTS[label_m] = tuple(
                    launches[k] / (TRAIN_WARMUP + TRAIN_STEPS) for k in TRUNK32_KERNELS)
            elif mode == "full_nocolor":
                TRUNK_BWD32_CALLS["f32 'full_nocolor' step"] = record_trunk_calls(
                    lambda: step(state, batch, gen))
            idle = [k for k in want if not launches[k]]
            stray = [k for k in kernels if k not in want and launches[k]]
            shown = (bwd32 > 0 and dw32 > 0 and not tn_f32 and not f32_g and not cdz_g
                     and bool(color32) == (mode == "full")) if want else total >= 0
            steps = TRAIN_WARMUP + TRAIN_STEPS
            off = {k: launches[k] for k, n in per_step[mode].items() if launches[k] != n * steps}
            if (not finite or moved <= 0 or idle or stray or not shown or bf16_g or bf16_tn
                    or off):
                bad.append(f"{label} (launches {launches}, finite {finite}, moved {moved:.2e}, "
                           f"per step {per_step[mode]})")
            if mode == "full":
                rows["K3"] = dict(rows.get("K3", {}), f32_dw_launches=launches["K3"])
                rows["POSE"] = dict(rows.get("POSE", {}), f32_launches=launches["POSE"])
                for name in ("UCHAIN", "BWDREV"):
                    rows[name] = dict(rows.get(name, {}), f32_train_launches=launches[name])
                # the seed's launches on the f32 trunk's main path, which the
                # fused u-chain took over: 0
                rows["UCHAIN"]["launches"] = launches["UCHAIN"]
                # gemm_tn_f32_kernel and gemm_f32_kernel: kept for comparison,
                # 0 on the step
                for name in gemms + ("GEMM_F32", "GEMM_TN_F32", "CFWD32", "CBWD32"):
                    rows[name] = dict(rows.get(name, {}), launches=launches[name])
                rows["COLSUM"] = dict(rows.get("COLSUM", {}), f32_launches=launches["COLSUM"])
            elif mode == "full_nocolor":
                for name in ("K2", "K3"):
                    rows[name] = dict(rows.get(name, {}), f32_nocolor_launches=launches[name])
            elif mode == "pallas":
                for name in ("K5", "K6", "PACK", "TFWD32", "TUCH32", "TUT32", "TDZ32", "TDW32"):
                    rows[name] = dict(rows.get(name, {}), f32_launches=launches[name])
                rows["GEMM_F32"] = dict(rows.get("GEMM_F32", {}),
                                        pallas_launches=launches["GEMM_F32"])
        assert not bad, f"an f32 train path is not as expected: {bad}"

    def perpoint_f32():
        """The pack at an f32 'pallas' step's calls and the pose sum at an
        f32 'full' step's (recorded in the train phase above), against
        their plain versions bit for bit (pack_readings, pose_readings)."""
        pal, full = f32_calls.get("pallas"), f32_calls.get("full")
        assert pal and full and pal.pack and full.pose, "the f32 train phase recorded no call"
        assert _tally(pal.pack) == pack_calls(torch)["f32 step"], \
            f"an f32 'pallas' step's packs {_tally(pal.pack)} are not pack_calls'"
        assert _tally(full.pose) == pose_calls(torch)["f32 step"], \
            f"an f32 step's pose sums {_tally(full.pose)} are not pose_calls'"
        packs = pack_readings(torch, dev, _tally(pal.pack))
        poses = pose_readings(torch, dev, _tally(full.pose))
        log_pack_pose("f32 step", packs, poses)
        pack_pose_row("f32_", packs, poses, rows)
        bad = [r for r in packs + poses if not r.ok]
        assert not bad, f"the pack or the pose sum disagrees at an f32 step: {bad}"

    def train_check_f32():
        """One 64-ray step per kernel mode, card against CPU."""
        bad = []
        for mode in ("full", "full_nocolor", "pallas"):
            r = train_check_readings(torch, fs, dev, mode=mode)
            label = f"train check f32 {mode}"
            log(f"{label}: metrics card / cpu: " + ", ".join(
                f"{k} {r.card[k]:.7g}/{r.cpu[k]:.7g}" for k in r.cpu))
            log(f"{label}: gradient leaves, |card - cpu| / |cpu|: "
                + " ".join(f"{x:.1e}" for x in r.rel))
            ok = r.worst_metric <= TOL_TRAIN_F32_LOSS and max(r.rel) <= TOL_TRAIN_F32_GRAD
            log(f"{label}: worst loss term {r.worst_metric:.2e} of its value (tol "
                f"{TOL_TRAIN_F32_LOSS:g}); worst leaf {max(r.rel):.2e} (tol "
                f"{TOL_TRAIN_F32_GRAD:g}); card {r.secs['cuda']:.2f} s, CPU {r.secs['cpu']:.2f} s"
                f"{'' if ok else ' FAIL'}")
            if not ok:
                bad.append(mode)
        assert not bad, f"the card's f32 train step disagrees with the CPU's: {bad}"

    def serve_f32():
        """One 4096-ray request through the eval render with the f32 trunk
        and 'full' (K1, K2 f32); the CHECK_RAYS rays of it that meet the
        most surface against the CPU render."""
        render = make_hand_eval_render(sdf_cfg, color_cfg, fs.rcfg,
                                       fs.tcfg._replace(fused_fine="full"))
        request = dict(view, rays_xy=rays)
        render(fs.params, request)   # packs the snapshot's weights
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        color, wsum = render(fs.params, request)
        torch.cuda.synchronize()
        req_ms = (time.perf_counter() - t0) * 1e3
        launches = {name: k.launches for name, k in kernels.items()}
        log(f"serve f32: one request of {len(rays)} rays in {req_ms:.1f} ms "
            f"({len(rays) / req_ms * 1e3:.1f} rays/s); launches {launches}")
        rows["K2"] = dict(rows.get("K2", {}), f32_request_launches=launches["K2"])
        for name in ("TFWD32", "TUCH32", "GEMM_F32", "CFWD32"):
            rows[name] = dict(rows.get(name, {}), request_launches=launches[name])
        TRUNK32_COUNTS["f32 request"] = tuple(launches[k] for k in TRUNK32_KERNELS)
        TRUNK32_CALLS["f32 request"] = record_trunk_calls(lambda: render(fs.params, request))
        assert bool(torch.isfinite(color).all()) and bool(torch.isfinite(wsum).all())
        assert launches["K1"] and launches["K2"] and launches["CFWD32"] and launches[
            "EMBED"] and launches["TFWD32"] and launches["TUCH32"] and not (
            launches["K3"] or launches["K5"] or launches["K6"] or launches["GEMM_TN_F32"]
            or launches["GEMM_F32"] or launches["CBWD32"] or launches["COLOR_DZ"]
            or launches["GEMM_TN"] or launches["COLSUM"] or launches["BWDREV"]
            or launches["UCHAIN"] or launches["TUT32"] or launches["TDZ32"]
            or launches["TDW32"]), \
            f"the f32 'full' render path launched {launches}"
        idx = torch.argsort(wsum.reshape(-1), descending=True)[:CHECK_RAYS]
        cpu = torch.device("cpu")
        c_ref, w_ref = render(clone_tree(fs.params, cpu),
                              {k: v.to(cpu) for k, v in request.items() if k != "rays_xy"}
                              | {"rays_xy": request["rays_xy"][idx].cpu()})
        ok = True
        for what, got, want in (("color", color[idx].cpu(), c_ref),
                                ("weight_sum", wsum[idx, 0].cpu(), w_ref[:, 0])):
            good, _, text = compare(torch, what, got, want, TOL_RENDER_MEDIAN, TOL_RENDER_MAX,
                                   scale=1.0)
            log(f"serve f32: {CHECK_RAYS} rays vs the CPU render (plain versions), {text}")
            ok = ok and good
        assert ok, "the f32 render disagrees with the CPU render"

    phase("f32 GEMMs", f32_gemms)
    phase("kernel K2 f32 request", kernel_k2_f32_request)
    phase("kernel K3 f32", kernel_k3_f32_dw)
    phase("kernel K2/K3 f32 no-color", kernel_nocolor_f32)
    phase("kernel K5/K6 f32", kernel_k5k6_f32)
    phase("train f32", train_f32)
    phase("per-point kernels f32", perpoint_f32)
    phase("train check f32", train_check_f32)
    phase("serve f32", serve_f32)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import honerf_torch  # noqa: F401
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

    import shutil
    import tempfile

    video_root = tempfile.mkdtemp(prefix="chip_smoke_seq_")
    video_gen = []
    try:
        return run_phases(torch, dev, phase, failures, rows, video_root, video_gen)
    finally:
        for proc, _ in video_gen:
            if proc.poll() is None:
                proc.kill()
            proc.wait()
        shutil.rmtree(video_root, ignore_errors=True)


def run_phases(torch, dev, phase, failures, rows, video_root, video_gen) -> int:
    """Every phase after the configuration's; returns the exit code.  The
    video phases' synthetic sequence is written under video_root by a child
    process started after the build (start_video_sequence, appended to
    video_gen), beside the first phases."""
    import numpy as np

    from honerf_torch.data.synthetic import canonical_hand_joints, posed_hand_example
    from honerf_torch.hand import bone_transforms_from_mano_joints
    from honerf_torch.models.embedding import hand_embedding_flat
    from honerf_torch.models.fields import pack_fine_color
    from honerf_torch.ops import _build
    from honerf_torch.ops import fused_fine as FT
    from honerf_torch.ops import fused_fine_full as FF
    from honerf_torch.ops import fused_hand as FH
    from honerf_torch.ops import fused_sdf as FS
    from honerf_torch.render.neus import pack_hand_field
    from honerf_torch.train.offline import (
        init_train_state,
        make_hand_eval_render,
        make_hand_train_step,
    )
    from honerf_torch.train.runner import render_full_image

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
    video_gen.append(start_video_sequence(video_root))

    # -- configuration and weights ---------------------------------------
    fs = flagship(torch, dev)
    sdf_cfg, color_cfg, rcfg, tcfg, params = fs.sdf, fs.color, fs.rcfg, fs.tcfg, fs.params
    H, W = fs.conf.get_list("dataset.image_size")
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
        got = FF.hand_fine_color_fwd(*args)
        want = FF.hand_fine_color_plain(*args)
        torch.cuda.synchronize()
        checks = [compare(torch, what, a, b) for what, a, b in zip(("sdf", "g", "color"), got,
                                                                   want)]
        ok = all(c[0] for c in checks)
        ms = cuda_ms(torch, lambda: FF.hand_fine_color_fwd(*args), 5)
        plain_ms = cuda_ms(torch, lambda: FF.hand_fine_color_plain(*args), 2)
        n_bytes = (nbytes([pts, rotT, off, cut, *pack.ws, *pack.bs, *pack.cws, *pack.cbs])
                   + 28 * pts.shape[0])
        b_ms, b_by = bound(k2_flops(sdf_cfg, color_cfg, pts.shape[0]), n_bytes)
        log(f"K2 hand_fine_color_fwd: {pts.shape[0]} pts ({-(-pts.shape[0] // FF.CHUNK)} passes); "
            f"{'; '.join(c[2] for c in checks)}; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        rows["K2"] = dict(name=FF.KERNEL.name, route="cuda", source=FF.KERNEL.source,
                          replaces=FF.KERNEL.replaces, max_abs_err=max(c[1] for c in checks),
                          points=pts.shape[0], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by, library_ms=None)
        if not ok:
            raise AssertionError("K2 disagrees with its plain version")

    def bf16_gemms():
        """Both bf16 GEMMs alone at a bf16 pass's shapes against f64
        (bf16_gemm_readings), timed beside one bf16 torch.matmul."""
        readings = bf16_gemm_readings(torch, dev)
        for r in readings:
            log(f"{r.what}, M {BF16_GEMM_M}: |kernel - f64| / |f64| in L2 {r.l2:.2e} (tol "
                f"{TOL_GEMM_BF16_L2:.2e}), max |err| {r.max_abs:.2e}, mean shrink "
                f"{r.shrink:.2e}; a rerun gives the same bits: {r.same}; kernel {r.ms:.4f} ms "
                f"({r.flops / r.ms / 1e9:.1f} TFLOP/s), plain (f32 product) {r.plain_ms:.4f} ms, "
                f"torch.matmul bf16 {r.lib_ms:.4f} ms, bound {r.bound_ms:.4f} ms "
                f"({r.bound_by}){'' if r.ok else ' FAIL'}")
        for key, gemm in (("GEMM", FH.GEMM), ("GEMM_TN", FH.GEMM_TN)):
            mine = [r for r in readings if r.what.split()[0] + "_kernel" == gemm.name]
            ms, lib_ms = sum(r.ms for r in mine), sum(r.lib_ms for r in mine)
            b_ms, plain_ms = sum(r.bound_ms for r in mine), sum(r.plain_ms for r in mine)
            log(f"{gemm.name}, the {len(mine)} shapes: kernel {ms:.4f} ms, torch.matmul bf16 "
                f"{lib_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms, "
                f"{sum(r.flops for r in mine) / ms / 1e9:.1f} TFLOP/s")
            rows[key] = dict(rows.get(key, {}), name=gemm.name, route="cuda", source=gemm.source,
                             replaces=gemm.replaces, max_abs_err=max(r.max_abs for r in mine),
                             ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=max(mine, key=lambda r: r.bound_ms).bound_by,
                             library_ms=lib_ms)
        if not all(r.ok for r in readings):
            raise AssertionError("a bf16 GEMM disagrees with the f64 sum or its rerun")

    phase("kernel K1", kernel_k1)
    phase("kernel K2", kernel_k2)
    phase("bf16 GEMMs", bf16_gemms)

    # -- 3. serve: full image + requests through the port's entry points --
    render = make_hand_eval_render(sdf_cfg, color_cfg, rcfg, tcfg)
    view = dict(cam_R=torch.as_tensor(cam_R, device=dev),
                cam_T=torch.as_tensor(cam_T, device=dev),
                focal=torch.tensor([3.0, 3.0], device=dev),
                principal=torch.zeros(2, device=dev), joints=joints_t, t_pose_21=t_pose)
    served = {}

    def serve():
        for k in (FH.KERNEL, FF.KERNEL, FH.GEMM, FH.GEMM_TN, FH.EMBED, FT.UCHAIN, FF.BWDREV,
                  FT.TRUNK_FWD, FT.TRUNK_UCHAIN, FF.COLOR_FWD, FF.COLOR_BWD, FF.COLOR_DZ):
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        color, wsum = render_full_image(render, params, view, H, W, chunk=REQUEST_RAYS)
        torch.cuda.synchronize()
        img_s = time.perf_counter() - t0
        image_colors, image_gemms = FF.COLOR_FWD.launches, FH.GEMM.launches
        from honerf_torch.camera import full_image_ndc_grid

        grid = full_image_ndc_grid(H, W, device=dev)
        req_ms, req_colors, req_gemms = [], [], []
        for i in range(N_REQUESTS):
            rays = grid[i * REQUEST_RAYS:(i + 1) * REQUEST_RAYS]
            before = FF.COLOR_FWD.launches, FH.GEMM.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            render(params, dict(view, rays_xy=rays))
            torch.cuda.synchronize()
            req_ms.append((time.perf_counter() - t0) * 1e3)
            req_colors.append(FF.COLOR_FWD.launches - before[0])
            req_gemms.append(FH.GEMM.launches - before[1])
        launches = {"K1": FH.KERNEL.launches, "K2": FF.KERNEL.launches,
                    "EMBED": FH.EMBED.launches, "TFWD": FT.TRUNK_FWD.launches,
                    "TUCH": FT.TRUNK_UCHAIN.launches, "CFWD16": FF.COLOR_FWD.launches}
        # the bf16 trunk runs as two fused launches a pass, the color net as
        # one: no u-chain seed, no gemm_kernel, color_fwd_kernel once a K2
        # pass
        stray_tn = (FH.GEMM_TN.launches + FF.BWDREV.launches + FT.UCHAIN.launches
                    + FH.GEMM.launches + FF.COLOR_BWD.launches + FF.COLOR_DZ.launches)
        n_rays = H * W
        passes = lambda rays: -(-rays * (rcfg.n_samples + rcfg.n_importance) // FF.CHUNK)  # noqa
        want_image = sum(passes(min(REQUEST_RAYS, n_rays - r0))
                         for r0 in range(0, n_rays, REQUEST_RAYS))
        # what the render pays once per parameter snapshot (and each request
        # paid before the packs were kept)
        pack_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pack_hand_field(params, sdf_cfg, color_cfg, fused_ladder=True, fine="full")
            torch.cuda.synchronize()
            pack_ms.append((time.perf_counter() - t0) * 1e3)
        for name, count in launches.items():
            rows.setdefault(name, {})["launches"] = count
        rows.setdefault("GEMM", {}).update(image_launches=image_gemms,
                                           request_launches=req_gemms[0])
        rows["CFWD16"].update(image_launches=image_colors, request_launches=req_colors[0])
        log(f"serve: image {H}x{W} = {n_rays} rays in {img_s * 1e3:.1f} ms "
            f"({n_rays / img_s:.1f} rays/s, {-(-n_rays // REQUEST_RAYS)} requests of "
            f"<= {REQUEST_RAYS} rays); requests of {REQUEST_RAYS} rays: "
            f"{', '.join(f'{m:.1f}' for m in req_ms)} ms "
            f"({REQUEST_RAYS / (sum(req_ms) / len(req_ms) / 1e3):.1f} rays/s); "
            f"launches {launches} ({image_colors} color_fwd_kernel in the image, {want_image} "
            f"expected: one a K2 pass; a request's {req_colors}; gemm_kernel "
            f"{FH.GEMM.launches}, color_dz_kernel {FF.COLOR_DZ.launches}, the "
            f"uchain_seed_kernel's {FT.UCHAIN.launches}); packing the weights of one snapshot "
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
        if not all(launches.values()) or stray_tn:
            raise AssertionError(f"a kernel of the render path did not launch: {launches} "
                                 f"(GEMMs, reverse-chain transposes, seeds, color transposes "
                                 f"{stray_tn})")
        if image_colors != want_image or req_colors != [passes(REQUEST_RAYS)] * N_REQUESTS:
            raise AssertionError(f"color_fwd_kernel launched {image_colors} times in the image "
                                 f"({want_image} expected) and {req_colors} in the requests")

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
        cpu_params = clone_tree(params, cpu)
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
        request = dict(view, rays_xy=served["grid"][:REQUEST_RAYS])
        device_profile(torch, f"one request of {REQUEST_RAYS} rays",
                       lambda: render(params, request), points=FF.CHUNK)

    if "serve" not in failures:
        phase("check", check)
        phase("profile", profile)
    else:
        failures.append("check")

    # -- 6-9. the hand model's offline train step ------------------------
    ttcfg = train_hyper(fs)
    all_kernels = {"K1": FH.KERNEL, "K2": FF.KERNEL, "K3": FF.KERNEL_BWD,
                   "K5": FT.KERNEL_FWD, "K6": FT.KERNEL_BWD, "GEMM": FH.GEMM,
                   "GEMM_TN": FH.GEMM_TN, "EMBED": FH.EMBED, "COLSUM": FT.COLSUM,
                   "UCHAIN": FT.UCHAIN, "BWDREV": FF.BWDREV, "COPY": FT.COPY, "PACK": FT.PACK,
                   "POSE": FF.POSE, "TFWD": FT.TRUNK_FWD, "TUCH": FT.TRUNK_UCHAIN,
                   "CFWD16": FF.COLOR_FWD, "CBWD16": FF.COLOR_BWD, "COLOR_DZ": FF.COLOR_DZ,
                   "TUT16": FT.TRUNK_UT, "TDZ16": FT.TRUNK_DZ}

    def bwd_rules(label, mode, args):
        """K3's two rules on the mode's backward kernel: on the step's own
        cotangents (L2 within TOL_K3_L2) and on unit cotangents (within
        K3_FACTOR x the card-vs-CPU plain distance + K3_REL)."""
        got, checks = k3_check(torch, args, mode)
        for c in checks:
            log(f"{label} {c.text}")
        units = k3_unit_check(torch, args, mode=mode)
        for c in units:
            log(f"{label} unit cotangents, {c.text}")
        return got, checks, [c.ok for c in checks + units]

    def kernel_k3():
        """On the inputs one flagship train step gives it (56,448 points,
        the loss's cotangents); every output against its range."""
        args = step_bwd_inputs(torch, fs, dev)
        pts, pack = args[0], args[4]
        n = pts.shape[0]
        got, checks, oks = bwd_rules("K3", "full", args)
        again = FF.hand_fine_color_bwd(*args)
        same = all(torch.equal(x, y) for x, y in zip(
            [again.dp, again.drotT, *again.dws, *again.dcws], [got.dp, got.drotT, *got.dws,
                                                               *got.dcws]))
        ms = cuda_ms(torch, lambda: FF.hand_fine_color_bwd(*args), 5)
        plain_ms = cuda_ms(torch, lambda: FF.hand_fine_color_plain_bwd(*args), 2)
        weights = [*pack.ws, *pack.bs, *pack.cws, *pack.cbs]
        n_bytes = (nbytes([*args[:4], *args[5:], *weights]) + 12 * n
                   + 4 * sum(w.numel() for w in weights) + 4 * 9 * 128)
        b_ms, b_by = bound(k3_flops(sdf_cfg, color_cfg, n), n_bytes)
        log(f"K3 hand_fine_color_bwd: {n} pts ({-(-n // FF.BWD_CHUNK)} passes); "
            f"{sum(oks)}/{len(oks)} comparisons within tolerance; a second run gives the same bits: "
            f"{same}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, {k3_flops(sdf_cfg, color_cfg, n) / 1e12:.3f} TFLOP)")
        rows["K3"] = dict(rows.get("K3", {}), name=FF.KERNEL_BWD.name, route="cuda",
                          source=FF.KERNEL_BWD.source, replaces=FF.KERNEL_BWD.replaces,
                          max_abs_err=max(c.max_abs for c in checks), points=n, ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if not all(oks) or not same:
            raise AssertionError("K3 disagrees with its plain version")

    def train_run(label, mode, n_steps, expect, profile=False):
        """TRAIN_WARMUP + n_steps flagship train steps with train.fused_fine
        = mode.  Every launch count is zeroed just before and read just
        after: the kernels in `expect` must have launched and the other
        fine-pass kernels not; the losses and grad norms finite,
        se3_refine moved.  Returns the launch counts."""
        tcfg_m = ttcfg._replace(fused_fine=mode)
        tparams = train_params(fs, dev)
        state = init_train_state(tparams, tcfg_m)
        step = make_hand_train_step(sdf_cfg, color_cfg, rcfg, tcfg_m)
        batch = train_batch(torch, TRAIN_RAYS, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        se3_before = tparams["se3_refine"].detach().clone()
        for k in all_kernels.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        metrics = []
        for _ in range(TRAIN_WARMUP):
            state, m = step(state, batch, gen)
            metrics.append(m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state, m = step(state, batch, gen)
            metrics.append(m)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {name: k.launches for name, k in all_kernels.items()}
        loss = torch.stack([m["loss"] for m in metrics])
        gnorm = torch.stack([m["grad_norm"] for m in metrics])
        finite = bool(torch.isfinite(loss).all()) and bool(torch.isfinite(gnorm).all())
        moved = float((tparams["se3_refine"].detach() - se3_before).abs().max())
        last = {k: round(float(v), 5) for k, v in metrics[-1].items()}
        log(f"{label}: {n_steps} steps of {TRAIN_RAYS} rays in {dt * 1e3:.1f} ms: "
            f"{dt * 1e3 / n_steps:.2f} ms/step, {TRAIN_RAYS * n_steps / dt:.1f} rays/s "
            f"(host clock, after {TRAIN_WARMUP} warm-up steps); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}")
        log(f"{label}: loss {', '.join(f'{x:.4f}' for x in loss.tolist())}")
        log(f"{label}: grad_norm first {float(gnorm[0]):.4f} last {float(gnorm[-1]):.4f}; "
            f"se3_refine moved by up to {moved:.3e}; last metrics {last}")
        if profile:
            device_profile(torch, f"one {label} step of {TRAIN_RAYS} rays",
                           lambda: step(state, batch, gen), points=TRAIN_FINE_PTS)
        assert finite, "a loss or gradient norm is not finite"
        assert moved > 0, "se3_refine did not move"
        idle = [k for k in expect if not launches[k]]
        stray = [k for k in ("K2", "K3", "K5", "K6", "BWDREV", "PACK", "POSE", "UCHAIN",
                             "CFWD16", "CBWD16", "COLOR_DZ", "GEMM")
                 if k not in expect and launches[k]]
        assert not idle and not stray, (
            f"the {mode} train path launched {launches}: expected {expect} and no other fine "
            "pass kernel")
        # the pack: two a 'pallas' step (K5, K6); the pose sum: one a step
        # of K3 (one pass of the step's 56,448 points); the trunk's backward
        # pair once each a step in every mode (K3's or K6's one pass) and no
        # gemm_kernel (its 17 a step before the pair); the bf16 color pair
        # ('full' only) a forward for K2's pass and K3's recompute, a
        # transpose for K3's, and no color_dz_kernel
        steps = TRAIN_WARMUP + n_steps
        full = mode == "full"
        per_step = {"PACK": 2 if mode == "pallas" else 0, "POSE": 1 if mode != "pallas" else 0,
                    "GEMM": 0, "TUT16": 1, "TDZ16": 1, "CFWD16": 2 if full else 0,
                    "CBWD16": 1 if full else 0, "COLOR_DZ": 0}
        off = {k: launches[k] for k, n in per_step.items() if launches[k] != n * steps}
        assert not off, f"the {mode} train path's {steps} steps launched {off}: per step {per_step}"
        return launches

    def train():
        launches = train_run("train", "full", TRAIN_STEPS,
                             ("K1", "K2", "K3", "GEMM_TN", "EMBED", "COLSUM", "TFWD", "TUCH",
                              "BWDREV", "POSE", "CFWD16", "CBWD16", "TUT16", "TDZ16"))
        rows.setdefault("CFWD16", {})["train_launches"] = launches["CFWD16"]
        rows.setdefault("CBWD16", {})["launches"] = launches["CBWD16"]
        rows.setdefault("K3", {})["launches"] = launches["K3"]
        # no main path launches gemm_kernel: the train step's count is 0
        rows.setdefault("GEMM", {}).update(launches=launches["GEMM"],
                                           train_launches=launches["GEMM"])
        for name in ("TUT16", "TDZ16"):
            rows.setdefault(name, {})["launches"] = launches[name]
        rows.setdefault("GEMM_TN", {})["launches"] = launches["GEMM_TN"]
        rows.setdefault("EMBED", {})["train_launches"] = launches["EMBED"]
        rows.setdefault("COLSUM", {})["launches"] = launches["COLSUM"]
        rows.setdefault("UCHAIN", {})["train_launches"] = launches["UCHAIN"]
        for name in ("TFWD", "TUCH"):
            rows.setdefault(name, {})["train_launches"] = launches[name]
        rows.setdefault("BWDREV", {})["launches"] = launches["BWDREV"]
        rows.setdefault("POSE", {})["launches"] = launches["POSE"]

    def train_check(mode="full", label="train check"):
        """One step on the card and on the CPU from the same state: the
        metrics, and each leaf's gradient before the clip."""
        r = train_check_readings(torch, fs, dev, mode=mode)
        for d, sec in r.secs.items():
            log(f"{label}: one step of {CHECK_TRAIN_RAYS} rays on {d} in {sec:.2f} s")
        log(f"{label}: metrics card / cpu: " + ", ".join(
            f"{k} {r.card[k]:.6g}/{r.cpu[k]:.6g}" for k in r.cpu))
        log(f"{label}: gradient leaves, |card - cpu| / |cpu|: "
            + " ".join(f"{x:.1e}" for x in r.rel))
        log(f"{label}: worst loss term {r.worst_metric:.2e} of its value (tol "
            f"{TOL_TRAIN_LOSS:g}); worst leaf {max(r.rel):.2e} (tol {TOL_TRAIN_GRAD:g})")
        assert r.worst_metric <= TOL_TRAIN_LOSS and max(r.rel) <= TOL_TRAIN_GRAD, \
            "the card's train step disagrees with the CPU's"

    def train_profile():
        tparams = train_params(fs, dev)
        state = init_train_state(tparams, ttcfg)
        step = make_hand_train_step(sdf_cfg, color_cfg, rcfg, ttcfg)
        batch = train_batch(torch, TRAIN_RAYS, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        step(state, batch, gen)
        device_profile(torch, f"one train step of {TRAIN_RAYS} rays",
                       lambda: step(state, batch, gen), points=TRAIN_FINE_PTS)

    phase("kernel K3", kernel_k3)
    phase("train", train)
    phase("train check", train_check)
    phase("train profile", train_profile)

    # -- 9b. the per-point kernels alone -----------------------------------
    def perpoint():
        """hand_embed_kernel, colsum_partial_kernel, uchain_seed_kernel and
        fine_bwd_rev_kernel alone at the calls one 4096-ray request and one
        bf16 train step make (recorded by running each once), each against
        its plain version (perpoint_readings, seed_readings,
        bwdrev_readings); the embedding and the seed also in f32 at the
        request's calls, both and the transpose at ragged sizes.  Times
        against the bound, the plain version and the library yardstick
        where one PyTorch call computes the function (the column sum: a torch
        sum; the seed: torch.mul); copy_cols_kernel (a 'full_nocolor' and a
        'pallas' step's copies) against dst[:, :w].copy_(src[:, :w]);
        trunk_pack_e_kernel (a 'pallas' step's and request's packs) against
        eb[:, :E].copy_(e) and pose_sum_kernel (a step's pose sum) against
        P[:m].sum(0), both bit for bit against their plain versions and at
        ragged sizes (pack_readings, pose_readings); then the yardstick of
        reduce_partials_kernel's sum, ws.sum(0), whose time the profiles
        give."""
        from honerf_torch.camera import full_image_ndc_grid
        from honerf_torch.ops import wgmma_layout as WL

        grid = served.get("grid")
        if grid is None:
            grid = full_image_ndc_grid(H, W, device=dev)
        request = dict(view, rays_xy=grid[:REQUEST_RAYS])
        req = record_perpoint_calls(lambda: render(params, request))
        state = init_train_state(train_params(fs, dev), ttcfg)
        step = make_hand_train_step(sdf_cfg, color_cfg, rcfg, ttcfg)
        batch = train_batch(torch, TRAIN_RAYS, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        stp = record_perpoint_calls(lambda: step(state, batch, gen))
        nc_cfg = ttcfg._replace(fused_fine="full_nocolor")
        nc_state = init_train_state(train_params(fs, dev), nc_cfg)
        nc_step = make_hand_train_step(sdf_cfg, color_cfg, rcfg, nc_cfg)
        nc = record_perpoint_calls(lambda: nc_step(nc_state, batch, gen))
        pl_cfg = ttcfg._replace(fused_fine="pallas")
        pl_state = init_train_state(train_params(fs, dev), pl_cfg)
        pl_step = make_hand_train_step(sdf_cfg, color_cfg, rcfg, pl_cfg)
        pal = record_perpoint_calls(lambda: pl_step(pl_state, batch, gen))
        render_p = make_hand_eval_render(sdf_cfg, color_cfg, rcfg,
                                         tcfg._replace(fused_fine="pallas"))
        preq = record_perpoint_calls(lambda: render_p(params, request))
        torch.cuda.synchronize()
        assert (req.embed and stp.embed and stp.colsum and stp.bwdrev
                and nc.copy and pal.copy and stp.tn and pal.pack and preq.pack and stp.pose), \
            "no per-point call was recorded"
        # the bf16 trunk's u-chain seeds itself (hand_uchain_kernel)
        assert not (req.seed or stp.seed or nc.seed or pal.seed or preq.seed), \
            "a bf16 path called the u-chain's seed"
        del state, nc_state, pl_state
        pose = (rotT, off, cut)
        f32_embeds = [(m, vL, rL, lde, torch.float32) for m, vL, rL, lde, _ in req.embed]
        groups = {}
        groups["request"], cols = perpoint_readings(torch, dev, pose, pts_all, req.embed,
                                                    stp.colsum)
        groups["step"] = perpoint_readings(torch, dev, pose, pts_all, stp.embed, [])[0]
        groups["f32 request"] = perpoint_readings(torch, dev, pose, pts_all, f32_embeds, [])[0]
        ragged = perpoint_readings(torch, dev, pose, pts_all, perpoint_calls(torch)[0][:2], [],
                                   timed=False)[0]
        for r in ragged:
            log(f"EMBED ragged: {r.m} pts {r.dtype}; {r.text}")
        totals = {}
        for label, rs in groups.items():
            for r in rs:
                log(f"EMBED {label}: {r.count} x {r.m} pts {r.dtype}; {r.text}; kernel "
                    f"{r.ms:.4f} ms, plain {r.plain_ms:.3f} ms, bound {r.bound_ms:.4f} ms "
                    f"({r.bound_by})")
            t = weighted(rs)
            pts = sum(r.m * r.count for r in rs)
            log(f"hand_embed_kernel, a {label}'s {sum(r.count for r in rs)} launches ({pts} "
                f"pts): kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, bound "
                f"{t['bound_ms']:.4f} ms: {t['bound_ms'] / t['ms']:.2f} of the bound")
            totals[label] = t
        for r in cols:
            log(f"COLSUM {r.count} x N {r.N}, {r.m} rows (ldz {r.ldz}): same bits as "
                f"colsum_ordered_plain {r.same}, on a rerun {r.rerun}, |err| vs f64 {r.f64:.2e} "
                f"(tol {TOL_COLSUM_F64:g}); kernel {r.ms:.4f} ms, Z[:m, :N].sum(0) "
                f"{r.lib_ms:.4f} ms, plain {r.plain_ms:.3f} ms, bound {r.bound_ms:.4f} ms "
                f"({r.bound_by}){'' if r.ok else ' FAIL'}")
        c = weighted(cols)
        log(f"colsum_partial_kernel, a bf16 step's {sum(r.count for r in cols)} launches: "
            f"kernel {c['ms']:.4f} ms, Z[:m, :N].sum(0) {c['lib_ms']:.4f} ms, plain "
            f"{c['plain_ms']:.3f} ms, bound {c['bound_ms']:.4f} ms: "
            f"{c['bound_ms'] / c['ms']:.2f} of the bound, {c['lib_ms'] / c['ms']:.2f}x the torch "
            f"sum's speed")
        all_emb = [r for rs in groups.values() for r in rs] + ragged
        req_t, stp_t, f32 = totals["request"], totals["step"], totals["f32 request"]
        rows["EMBED"] = dict(rows.get("EMBED", {}), name=FH.EMBED.name, route="cuda",
                             source=FH.EMBED.source, replaces=FH.EMBED.replaces,
                             max_abs_err=max(r.max_abs for r in all_emb), ms=req_t["ms"],
                             plain_ms=req_t["plain_ms"], bound_ms=req_t["bound_ms"],
                             bound_by=max(groups["request"], key=lambda r: r.bound_ms).bound_by,
                             library_ms=None, step_ms=stp_t["ms"],
                             step_bound_ms=stp_t["bound_ms"], f32_ms=f32["ms"],
                             f32_plain_ms=f32["plain_ms"], f32_bound_ms=f32["bound_ms"])
        rows["COLSUM"] = dict(rows.get("COLSUM", {}), name=FT.COLSUM.name, route="cuda",
                              source=FT.COLSUM.source, replaces=FT.COLSUM.replaces,
                              max_abs_err=max(r.max_abs for r in cols), ms=c["ms"],
                              plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
                              bound_by=max(cols, key=lambda r: r.bound_ms).bound_by,
                              library_ms=c["lib_ms"])
        # the u-chain's seed, the f32 trunk's only: an f32 request's calls
        # (K2 f32's passes of a request), an f32 step's (K2 f32's and K3
        # f32's recompute), ragged
        def f32_seeds(n, passes_a_call):
            C = FT.chunk_size(n, "f32", FF.CHUNK)
            return [(min(C, n - s0), 256, 256, torch.float32)
                    for s0 in range(0, n, C)] * passes_a_call
        seeds = {"f32 request": seed_readings(torch, dev, f32_seeds(k2_points, 1)),
                 "f32 step": seed_readings(torch, dev, f32_seeds(TRAIN_FINE_PTS, 2))}
        ragged_seed = seed_readings(torch, dev, seed_calls(torch), timed=False)
        st = {}
        for label, rs in seeds.items():
            for r in rs:
                log(f"UCHAIN {label}: {r.count} x {r.m} rows x {r.width} {r.dtype}: the same bits "
                    f"as uchain_seed_plain {r.same}, as torch.mul(..., out=) {r.same_lib}; kernel "
                    f"{r.ms:.4f} ms, torch.mul {r.lib_ms:.4f} ms, plain {r.plain_ms:.3f} ms, "
                    f"bound {r.bound_ms:.4f} ms ({r.bound_by}){'' if r.ok else ' FAIL'}")
            t = st[label] = weighted(rs)
            log(f"uchain_seed_kernel, a {label}'s {sum(r.count for r in rs)} launches "
                f"({sum(r.m * r.count for r in rs)} rows): kernel {t['ms']:.4f} ms, torch.mul "
                f"{t['lib_ms']:.4f} ms, plain {t['plain_ms']:.3f} ms, bound {t['bound_ms']:.4f} ms: "
                f"{t['bound_ms'] / t['ms']:.2f} of the bound, {t['lib_ms'] / t['ms']:.2f}x "
                f"torch.mul's speed")
        for r in ragged_seed:
            log(f"UCHAIN ragged: {r.m} rows {r.dtype}: the same bits as uchain_seed_plain "
                f"{r.same}, as torch.mul {r.same_lib}{'' if r.ok else ' FAIL'}")
        all_seed = [r for rs in seeds.values() for r in rs] + ragged_seed
        rows["UCHAIN"] = dict(rows.get("UCHAIN", {}), name=FT.UCHAIN.name, route="cuda",
                              source=FT.UCHAIN.source, replaces=FT.UCHAIN.replaces,
                              max_abs_err=max(r.max_abs for r in all_seed),
                              ms=st["f32 request"]["ms"], plain_ms=st["f32 request"]["plain_ms"],
                              bound_ms=st["f32 request"]["bound_ms"], bound_by="bytes",
                              library_ms=st["f32 request"]["lib_ms"],
                              step_ms=st["f32 step"]["ms"],
                              step_bound_ms=st["f32 step"]["bound_ms"],
                              f32_ms=st["f32 request"]["ms"],
                              f32_plain_ms=st["f32 request"]["plain_ms"],
                              f32_bound_ms=st["f32 request"]["bound_ms"],
                              f32_library_ms=st["f32 request"]["lib_ms"])
        # K3's reverse-chain transpose: a bf16 step's call, ragged sizes
        revs = bwdrev_readings(torch, dev, pose, pts_all, stp.bwdrev)
        ragged_rev = bwdrev_readings(torch, dev, pose, pts_all, bwdrev_calls(torch), timed=False)
        for r in revs:
            log(f"BWDREV step: {r.count} x {r.m} pts {r.dtype}; {r.text}; kernel {r.ms:.4f} ms, "
                f"plain {r.plain_ms:.3f} ms, bound {r.bound_ms:.4f} ms ({r.bound_by}): "
                f"{r.bound_ms / r.ms:.2f} of the bound")
        for r in ragged_rev:
            log(f"BWDREV ragged: {r.m} pts {r.dtype}; {r.text}")
        b = weighted(revs, ("ms", "plain_ms", "bound_ms"))
        rows["BWDREV"] = dict(rows.get("BWDREV", {}), name=FF.BWDREV.name, route="cuda",
                              source=FF.BWDREV.source, replaces=FF.BWDREV.replaces,
                              max_abs_err=max(r.max_abs for r in revs + ragged_rev),
                              ms=b["ms"], plain_ms=b["plain_ms"], bound_ms=b["bound_ms"],
                              bound_by="bytes", library_ms=None)
        # the yardsticks of the per-point kernels timed in the profiles
        ygen = torch.Generator(device=dev).manual_seed(31)
        copies = {}
        for label, rec in (("full_nocolor", nc), ("pallas", pal)):
            # copy_calls (check_k3_faults' copy check and bench_gemm read it)
            # is these steps' recorded calls
            assert _tally(rec.copy) == copy_calls(torch)[label], \
                f"a {label} step's copy_cols calls {_tally(rec.copy)} are not copy_calls'"
            rs = copies[label] = copy_readings(torch, dev, _tally(rec.copy))
            for r in rs:
                log(f"COPY {label}: {r.count} x {r.m} rows x {r.width} ({r.dtype}, lds {r.lds} "
                    f"+{r.so}, ldd {r.ldd} +{r.do}): the same bits as copy_cols_plain and "
                    f"copy_ {r.same}, the rest untouched {r.ok}; kernel {r.ms:.4f} ms, "
                    f"dst[:, :w].copy_(src[:, :w]) {r.lib_ms:.4f} ms, plain {r.plain_ms:.4f} ms, "
                    f"bound {r.bound_ms:.4f} ms ({r.bound_by}): {r.bound_ms / r.ms:.2f} of the "
                    f"bound, {r.lib_ms / r.ms:.2f}x copy_'s speed{'' if r.ok else ' FAIL'}")
            t = weighted(rs)
            log(f"copy_cols_kernel, a {label} step's {sum(r.count for r in rs)} launches: kernel "
                f"{t['ms']:.4f} ms, copy_ {t['lib_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                f"bound {t['bound_ms']:.4f} ms: {t['bound_ms'] / t['ms']:.2f} of the bound, "
                f"{t['lib_ms'] / t['ms']:.2f}x copy_'s speed")
            copies[label] = (rs, t)
        (nc_rs, nc_t), (pl_rs, pl_t) = copies["full_nocolor"], copies["pallas"]
        rows["COPY"] = dict(rows.get("COPY", {}), name=FT.COPY.name, route="cuda",
                            source=FT.COPY.source, replaces=FT.COPY.replaces,
                            max_abs_err=max(r.max_abs for r in nc_rs + pl_rs), ms=nc_t["ms"],
                            plain_ms=nc_t["plain_ms"], bound_ms=nc_t["bound_ms"],
                            bound_by="bytes", library_ms=nc_t["lib_ms"], pallas_ms=pl_t["ms"],
                            pallas_plain_ms=pl_t["plain_ms"], pallas_bound_ms=pl_t["bound_ms"],
                            pallas_library_ms=pl_t["lib_ms"])
        bad_copy = [r for r in nc_rs + pl_rs if not r.ok]
        assert not bad_copy, f"copy_cols_kernel disagrees with the copy: {bad_copy}"
        # K5 / K6's operand (a 'pallas' step's and a 'pallas' request's
        # packs) and K3's pose sums (a bf16 'full' step's call), at the
        # recorded calls (pack_calls / pose_calls, which check_k3_faults and
        # bench_gemm read)
        for label, rec in (("step", pal), ("request", preq)):
            assert _tally(rec.pack) == pack_calls(torch)[label], \
                f"a 'pallas' {label}'s pack calls {_tally(rec.pack)} are not pack_calls'"
        assert _tally(stp.pose) == pose_calls(torch)["step"], \
            f"a step's pose sums {_tally(stp.pose)} are not pose_calls'"
        packs = {label: pack_readings(torch, dev, _tally(rec.pack))
                 for label, rec in (("step", pal), ("request", preq))}
        poses = pose_readings(torch, dev, _tally(stp.pose))
        log_pack_pose("bf16 'pallas' step", packs["step"], [])
        log_pack_pose("'pallas' request", packs["request"], [])
        log_pack_pose("bf16 'full' step", [], poses)
        pack_pose_row("", packs["step"], poses, rows)
        pack_pose_row("request_", packs["request"], [], rows)
        rg_pack, rg_pose = ragged_pack_pose_calls(torch)
        ragged_pp = (pack_readings(torch, dev, rg_pack, timed=False)
                     + pose_readings(torch, dev, rg_pose, timed=False))
        for r in ragged_pp:
            log(f"{'POSE' if hasattr(r, 'acc') else 'PACK'} ragged: {r.m} rows: the same bits as "
                f"its plain version {r.same}{'' if r.ok else ' FAIL'}")
        bad_pp = [r for r in packs["step"] + packs["request"] + poses + ragged_pp if not r.ok]
        assert not bad_pp, f"the pack or the pose sum disagrees with its plain version: {bad_pp}"
        lib_tot = 0.0
        for (K, N, mm, dt), count in _tally(stp.tn).items():
            split = WL.tn_split(K, N, mm, 132)
            S = -(-mm // split)
            Kp, Np = -(-K // WL.BM) * WL.BM, -(-N // WL.BN_TN) * WL.BN_TN
            part = torch.randn((S, Kp, Np), generator=ygen, device=dev)
            lib_tot += count * cuda_ms(torch, lambda: part.sum(0), 20)
            del part
        log(f"reduce_partials_kernel's sums, a bf16 step's {len(stp.tn)} dW products: "
            f"ws.sum(0) {lib_tot:.4f} ms, bound {reduce_bound_ms(_tally(stp.tn)):.4f} ms (bytes: "
            f"the partials read once, dW written once; the kernel's time: the profiles); a "
            f"'pallas' step's {len(pal.tn)}: bound {reduce_bound_ms(_tally(pal.tn)):.4f} ms")
        bad = [r for r in all_emb + cols + all_seed + revs + ragged_rev if not r.ok]
        if bad:
            raise AssertionError(f"a per-point kernel disagrees with its plain version: {bad}")

    phase("per-point kernels", perpoint)

    # -- 9c. the bf16 trunk's two fused kernels alone ----------------------
    def fused_trunk():
        """hand_trunk_fwd_kernel and hand_uchain_kernel alone at the calls
        one 4096-ray request and one bf16 'full', 'full_nocolor' and
        'pallas' step make (recorded through the wrappers,
        record_trunk_calls), and at ragged sizes (ragged_trunk_calls),
        against their plain versions on the card (trunk_readings: the
        kernel rule on every output the call asks for, a rerun's bits),
        timed beside the plain versions and their bounds; the reciprocal of
        the forward's sigmoid against __frcp_rn at every f32 in [1, 2];
        K1 through its entry point (fused_hand_sdf: hand_embed_kernel then
        hand_trunk_fwd_kernel a chunk) at 1 to 262,144 points against
        fused_hand_sdf_plain, each call's CUDA graph nodes one embedding
        and one fused launch a chunk and no GEMM; a request's K2 call's
        graph nodes: color_fwd_kernel once a pass (the color net), the
        fused pair once a pass, no gemm_kernel and no u-chain seed; the
        bf16 color calls of each path, kept for phase "fused color bf16"
        (COLOR16_CALLS)."""
        from honerf_torch.camera import full_image_ndc_grid

        nets = trunk_nets(torch, dev, fs)
        grid = served.get("grid")
        if grid is None:
            grid = full_image_ndc_grid(H, W, device=dev)
        request = dict(view, rays_xy=grid[:REQUEST_RAYS])
        recs = {"request": record_trunk_calls(lambda: render(params, request))}
        for mode in ("full", "full_nocolor", "pallas"):
            cfg_m = ttcfg._replace(fused_fine=mode)
            st = init_train_state(train_params(fs, dev), cfg_m)
            stp = make_hand_train_step(sdf_cfg, color_cfg, rcfg, cfg_m)
            batch = train_batch(torch, TRAIN_RAYS, dev)
            gen = torch.Generator(device=dev).manual_seed(0)
            recs[f"'{mode}' step"] = record_trunk_calls(lambda: stp(st, batch, gen))
            del st
        torch.cuda.synchronize()
        mismatches = FT.rcp12_mismatches(dev)
        log(f"fused trunk: tf_rcp12 against __frcp_rn at every f32 in [1, 2]: {mismatches} "
            f"mismatches")
        groups, bad = {}, []
        for label, calls in recs.items():
            COLOR16_CALLS[label] = color16_calls(calls)
            TRUNK_BWD16_CALLS[label] = trunk_bwd32_calls(calls)
            calls = [c for c in calls if c[0] in ("fwd", "uc")]
            rs = groups[label] = trunk_readings(torch, dev, nets, calls)
            for r in rs:
                log(f"fused trunk, {label}: {trunk_text(r)}")
            bad += [r for r in rs if not r.ok]
        for r in trunk_readings(torch, dev, nets, ragged_trunk_calls(), timed=False):
            log(f"fused trunk, ragged: {trunk_text(r)}")
            bad += [r] if not r.ok else []
        # K1 through its entry point, and the launches of its CUDA graph
        rotT_, off_, cut_ = nets.pose
        k1 = nets.k1
        k1_ok, k1_err = [], []
        for n in (1, 63, 64, 65, 1001, 65613, 262144):
            args = (nets.pts[:n], rotT_, off_, cut_, k1.ws, k1.bs, k1.meta)
            ok, err, text = compare(torch, "sdf", FH.fused_hand_sdf(*args),
                                    FH.fused_hand_sdf_plain(*args))
            nodes = graph_kernel_nodes(torch, lambda: FH.fused_hand_sdf(*args))
            chunks = -(-n // FH.CHUNK)
            count = {k: sum(k in x for x in nodes) for k in ("hand_embed_kernel",
                                                             "hand_trunk_fwd_kernel",
                                                             "gemm_kernel")}
            good = (ok and count["hand_embed_kernel"] == count["hand_trunk_fwd_kernel"] == chunks
                    and count["gemm_kernel"] == 0 and len(nodes) == 2 * chunks)
            log(f"fused trunk, K1 at {n} points: {text}; its CUDA graph: {len(nodes)} nodes, "
                f"{count} ({chunks} chunks){'' if good else ' FAIL'}")
            k1_ok.append(good)
            k1_err.append(err)
        fine_args = (pts_all, rotT, off, cut, nets.fine)
        FF.hand_fine_color_fwd(*fine_args)
        nodes = graph_kernel_nodes(torch, lambda: FF.hand_fine_color_fwd(*fine_args))
        k2_passes = -(-pts_all.shape[0] // FF.CHUNK)
        count = {k: sum(k in x for x in nodes) for k in (
            "gemm_kernel", "hand_trunk_fwd_kernel", "hand_uchain_kernel", "uchain_seed_kernel",
            "hand_embed_kernel", "color_fwd_kernel")}
        k2_good = count == {"gemm_kernel": 0, "hand_trunk_fwd_kernel": k2_passes,
                            "hand_uchain_kernel": k2_passes, "uchain_seed_kernel": 0,
                            "hand_embed_kernel": k2_passes, "color_fwd_kernel": k2_passes}
        log(f"fused trunk, K2 at a request's {pts_all.shape[0]} points: its CUDA graph: "
            f"{len(nodes)} nodes, {count} ({k2_passes} passes){'' if k2_good else ' FAIL'}")
        # the kernels line: a request's calls (K1's five and K2's eight) and
        # a bf16 'full' step's, each weighted by its count
        req, step = groups["request"], groups["'full' step"]

        def tot(rs, kind, pred=lambda r: True):
            return weighted([r for r in rs if r.kind == kind and pred(r)],
                            ("ms", "plain_ms", "bound_ms"))

        fw, uc = tot(req, "fwd"), tot(req, "uc")
        k1_t, k2_t = tot(req, "fwd", lambda r: r.a == "sdf"), tot(req, "fwd", lambda r: r.a != "sdf")
        sfw, suc = tot(step, "fwd"), tot(step, "uc")
        every = [r for rs in groups.values() for r in rs]
        for key, kern, t, st_t, kind in (("TFWD", FT.TRUNK_FWD, fw, sfw, "fwd"),
                                         ("TUCH", FT.TRUNK_UCHAIN, uc, suc, "uc")):
            mine = [r for r in every if r.kind == kind]
            rows[key] = dict(rows.get(key, {}), name=kern.name, route="cuda", source=kern.source,
                             replaces=kern.replaces, max_abs_err=max(r.max_abs for r in mine),
                             ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                             bound_by=max([r for r in req if r.kind == kind],
                                          key=lambda r: r.bound_ms).bound_by,
                             library_ms=None, step_ms=st_t["ms"], step_plain_ms=st_t["plain_ms"],
                             step_bound_ms=st_t["bound_ms"])
        rows["TFWD"].update(k1_ms=k1_t["ms"], k1_bound_ms=k1_t["bound_ms"], k2_ms=k2_t["ms"],
                            k2_bound_ms=k2_t["bound_ms"])
        log(f"hand_trunk_fwd_kernel, a request's {sum(r.count for r in req if r.kind == 'fwd')} "
            f"launches: {fw['ms']:.4f} ms (K1's {k1_t['ms']:.4f}, bound {k1_t['bound_ms']:.4f}; "
            f"K2's {k2_t['ms']:.4f}, bound {k2_t['bound_ms']:.4f}), plain {fw['plain_ms']:.3f} ms; "
            f"a bf16 'full' step's: {sfw['ms']:.4f} ms, bound {sfw['bound_ms']:.4f} ms")
        log(f"hand_uchain_kernel, a request's {sum(r.count for r in req if r.kind == 'uc')} "
            f"launches: {uc['ms']:.4f} ms, bound {uc['bound_ms']:.4f} ms, plain "
            f"{uc['plain_ms']:.3f} ms; a bf16 'full' step's: {suc['ms']:.4f} ms, bound "
            f"{suc['bound_ms']:.4f} ms")
        rows["K1"] = dict(rows.get("K1", {}), ragged_max_abs_err=max(k1_err))
        if bad or mismatches or not all(k1_ok) or not k2_good:
            raise AssertionError(f"the fused trunk disagrees with its plain version, its bits "
                                 f"or its launch counts: {[trunk_text(r) for r in bad]}")

    phase("fused trunk", fused_trunk)

    def fused_color_bf16():
        """The bf16 color net's two kernels (color_fwd_kernel,
        color_bwd_kernel) alone at the calls one request and one bf16
        'full' step make (recorded by phase "fused trunk") and at ragged
        sizes: every output against the plain versions, the split
        launches' bits (and f64 where they move) (color16_readings), timed
        beside the split launches, the plain versions and the bounds; each
        path's recorded calls (the forward once a pass of K2 and of K3's
        recompute, the transpose once a pass of K3, with the dz rows)."""
        bad = []
        # (forward calls, transpose calls, the transpose's dz rows) a path makes
        want_calls = {"'full' step": (2, 1, True), "request": (8, 0, False),
                      "'full_nocolor' step": (0, 0, False), "'pallas' step": (0, 0, False)}
        for label, (nf, nb, dz) in want_calls.items():
            cs = COLOR16_CALLS.get(label)
            fwd = [c for c in cs or () if c[0] == "cfwd16"]
            bwd = [c for c in cs or () if c[0] == "cbwd16"]
            good = (cs is not None and len(fwd) == nf and len(bwd) == nb
                    and all(c[2] == dz for c in bwd) and sum(c[2] for c in fwd) == nb)
            log(f"fused color bf16, {label}: {len(fwd)} forward calls "
                f"({sum(c[2] for c in fwd)} keeping the relu rows), {len(bwd)} transpose calls "
                f"(dz rows {dz}){'' if good else ' FAIL'}")
            bad += [] if good else [f"{label}'s calls"]
        nets = trunk_nets(torch, dev, fs)
        groups = {}
        for label in ("request", "'full' step"):
            calls = COLOR16_CALLS.get(label)
            if not calls:
                bad.append(f"{label} not recorded")
                continue
            rs = groups[label] = color16_readings(torch, dev, nets, calls)
            for r in rs:
                log(f"fused color bf16, {label}: {color16_text(r)}")
            t = {kind: weighted([r for r in rs if r.kind == kind],
                                ("ms", "split_ms", "plain_ms", "bound_ms"))
                 for kind in ("cfwd16", "cbwd16")}
            pair = {k: sum(t[kind].get(k, 0.0) for kind in t)
                    for k in ("ms", "split_ms", "plain_ms", "bound_ms")}
            log(f"fused color bf16, {label}'s {sum(r.count for r in rs)} calls: "
                + ", ".join(f"{name} {t[kind]['ms']:.4f} ms against the split launches' "
                            f"{t[kind]['split_ms']:.4f} ms (bound {t[kind]['bound_ms']:.4f})"
                            for kind, name in (("cfwd16", "color_fwd_kernel"),
                                               ("cbwd16", "color_bwd_kernel")) if t[kind])
                + f"; the pair {pair['ms']:.4f} ms against the split launches' "
                f"{pair['split_ms']:.4f} ms ({pair['ms'] / pair['split_ms']:.2f} of it), bound "
                f"{pair['bound_ms']:.4f} ms: {pair['bound_ms'] / pair['ms']:.2f} of it (the "
                f"split's {pair['bound_ms'] / pair['split_ms']:.2f})")
            bad += [color16_text(r) for r in rs if not r.ok]
        for r in color16_readings(torch, dev, nets, ragged_color16_calls(), timed=False):
            log(f"fused color bf16, ragged: {color16_text(r)}")
            bad += [] if r.ok else [color16_text(r)]
        every = [r for rs in groups.values() for r in rs]
        moved = sorted({w for r in every for w in r.moved})
        log(f"fused color bf16: outputs whose bits moved against the split launches at the "
            f"recorded calls: {moved or 'none'}")
        keys = ("ms", "split_ms", "plain_ms", "bound_ms")
        for key, kern, kind in (("CFWD16", FF.COLOR_FWD, "cfwd16"),
                                ("CBWD16", FF.COLOR_BWD, "cbwd16")):
            mine = [r for r in every if r.kind == kind]
            tot = {label: weighted([r for r in rs if r.kind == kind], keys)
                   for label, rs in groups.items()}
            step = tot.get("'full' step") or {}
            rows[key] = dict(rows.get(key, {}), name=kern.name, route="cuda", source=kern.source,
                             replaces=kern.replaces,
                             max_abs_err=max((r.max_abs for r in mine), default=None),
                             ms=step.get("ms"), plain_ms=step.get("plain_ms"),
                             bound_ms=step.get("bound_ms"),
                             bound_by=max(mine, key=lambda r: r.bound_ms or 0).bound_by
                             if mine else None,
                             library_ms=None, step_split_ms=step.get("split_ms"),
                             bits_moved=sorted({w for r in mine for w in r.moved}))
            if tot.get("request"):
                rows[key].update({f"request_{k}": tot["request"][k]
                                  for k in ("ms", "split_ms", "bound_ms")})
        if bad:
            raise AssertionError("the bf16 color net's pair disagrees with its plain versions, "
                                 f"the split launches, its bits or its calls: {bad}")

    if "fused trunk" not in failures:
        phase("fused color bf16", fused_color_bf16)
    else:
        failures.append("fused color bf16")

    def fused_trunk_bwd_bf16():
        """The bf16 trunk backward's two kernels (hand_trunk_ut_kernel,
        hand_trunk_dz_kernel) at the calls one bf16 'full', 'full_nocolor'
        and 'pallas' step make (recorded by phase "fused trunk": K3's or
        K6's one pass, with the kept rows) and at ragged sizes
        (trunk_bwd16_readings: each chain against its plain version, every
        output through cuda_trunk_backward against eight reruns' bits and
        the split launches' SHA-256), timed in turns against the split chain;
        each path's recorded calls (one upward and one downward chain a
        step, none a request)."""
        bad = []
        want_calls = {"'full' step": 1, "'full_nocolor' step": 1, "'pallas' step": 1,
                      "request": 0}
        for label, k in want_calls.items():
            cs = TRUNK_BWD16_CALLS.get(label)
            good = cs is not None and len(cs) == k and all(keep for _, keep in cs)
            log(f"fused trunk backward bf16, {label}: {len(cs or ())} chains "
                f"{sorted(set(cs or ()))}{'' if good else ' FAIL'}")
            bad += [] if good else [f"{label}'s calls"]
        nets = trunk_nets(torch, dev, fs)
        groups = {}
        for label in ("'full' step", "'full_nocolor' step", "'pallas' step"):
            calls = TRUNK_BWD16_CALLS.get(label)
            if not calls:
                bad.append(f"{label} not recorded")
                continue
            rs = groups[label] = trunk_bwd16_readings(torch, dev, nets, calls)
            for r in rs:
                log(f"fused trunk backward bf16, {label}: {trunk_bwd16_text(r)}")
            bad += [trunk_bwd16_text(r) for r in rs if not r.ok]
        for r in trunk_bwd16_readings(torch, dev, nets, ragged_trunk_bwd32_calls(),
                                      timed=False):
            log(f"fused trunk backward bf16, ragged: {trunk_bwd16_text(r)}")
            bad += [] if r.ok else [trunk_bwd16_text(r)]
        every = [r for rs in groups.values() for r in rs]
        moved = sorted({k for r in every for k in r.moved})
        log(f"fused trunk backward bf16: outputs whose bits moved against the split launches at "
            f"the recorded calls: {moved or 'none'}")
        keys = ("ms", "split_ms", "plain_ms", "bound_ms", "ut_ms", "dz_ms", "ut_plain_ms",
                "dz_plain_ms", "ut_bound_ms", "dz_bound_ms")
        tot = {label: weighted(rs, keys) for label, rs in groups.items()}
        prefix = {"'full' step": "step_", "'full_nocolor' step": "nocolor_",
                  "'pallas' step": "pallas_"}
        for key, kern, part in (("TUT16", FT.TRUNK_UT, "ut"), ("TDZ16", FT.TRUNK_DZ, "dz")):
            step = tot.get("'full' step") or {}
            rows[key] = dict(rows.get(key, {}), name=kern.name, route="cuda", source=kern.source,
                             replaces=kern.replaces,
                             max_abs_err=max((r.max_abs for r in every), default=None),
                             ms=step.get(f"{part}_ms"), plain_ms=step.get(f"{part}_plain_ms"),
                             bound_ms=step.get(f"{part}_bound_ms"),
                             bound_by=getattr((groups.get("'full' step") or [None])[0],
                                              f"{part}_bound_by", None),
                             library_ms=None, bits_moved=moved)
            for label, t in tot.items():
                if label != "'full' step":
                    rows[key].update({f"{prefix[label]}ms": t.get(f"{part}_ms"),
                                      f"{prefix[label]}bound_ms": t.get(f"{part}_bound_ms")})
        for label, t in tot.items():
            rows["TUT16"].update({f"{prefix[label]}pair_ms": t.get("ms"),
                                  f"{prefix[label]}pair_split_ms": t.get("split_ms"),
                                  f"{prefix[label]}pair_bound_ms": t.get("bound_ms")})
            if t:
                log(f"fused trunk backward bf16, {label}: the pair {t['ms']:.4f} ms against the "
                    f"split chain's {t['split_ms']:.4f} ms ({t['ms'] / t['split_ms']:.2f} of "
                    f"it), bound {t['bound_ms']:.4f} ms: {t['bound_ms'] / t['ms']:.2f} of it "
                    f"(the split's {t['bound_ms'] / t['split_ms']:.2f})")
        if bad:
            raise AssertionError("the bf16 trunk backward's pair disagrees with its plain "
                                 f"versions, the split launches, its bits or its calls: {bad}")

    if "fused trunk" not in failures:
        phase("fused trunk backward bf16", fused_trunk_bwd_bf16)
    else:
        failures.append("fused trunk backward bf16")

    # -- 14-20. the fine pass's other kernel modes: 'pallas' (K5 / K6 on the
    # embedding) and 'full_nocolor' (K2 / K3 without the color net) --------
    E, d_out = sdf_cfg.input_width, sdf_cfg.d_out
    n_trunk_w = sum(i * o for i, o in trunk_dims(sdf_cfg, d_out))
    k6_inputs = {}

    def kernel_k5():
        """On the embedding of a flagship 'pallas' step's fine points
        (56,448) and of one request's (524,288); the step's numbers go into
        the kernels line."""
        args = step_bwd_inputs(torch, fs, dev, mode="pallas")
        k6_inputs["args"] = args
        e_step, tpack = args[0], args[1]
        with torch.no_grad():
            e_req = hand_embedding_flat(pts_all, bt_inv, t_pose, sdf_cfg.v_multires,
                                        sdf_cfg.r_multires)[0].contiguous()
        oks, errs = [], []
        for label, e, iters in (("step", e_step, 5), ("request", e_req, 3)):
            n = e.shape[0]
            got = FT.hand_trunk_sdf_u_fwd(e, tpack)
            want = FT.hand_trunk_sdf_u_plain(e, tpack)
            torch.cuda.synchronize()
            checks = [compare(torch, what, a, b) for what, a, b in zip(("out", "u"), got, want)]
            oks += [c[0] for c in checks]
            errs += [c[1] for c in checks]
            ms = cuda_ms(torch, lambda: FT.hand_trunk_sdf_u_fwd(e, tpack), iters)
            plain_ms = cuda_ms(torch, lambda: FT.hand_trunk_sdf_u_plain(e, tpack), 2)
            n_bytes = (4 * (2 * E + d_out) * n + nbytes([*tpack.ws, *tpack.bs]))
            b_ms, b_by = bound(k5_flops(sdf_cfg, n), n_bytes)
            log(f"K5 hand_trunk_sdf_u_fwd, {label}: {n} pts ({-(-n // FT.CHUNK)} passes); "
                f"{'; '.join(c[2] for c in checks)}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                f"bound {b_ms:.4f} ms ({b_by}, {k5_flops(sdf_cfg, n) / 1e12:.3f} TFLOP, "
                f"{k5_flops(sdf_cfg, n) / ms / 1e9:.1f} TFLOP/s)")
            rows.setdefault("K5", dict(name=FT.KERNEL_FWD.name, route="cuda",
                                       source=FT.KERNEL_FWD.source,
                                       replaces=FT.KERNEL_FWD.replaces, points=n, ms=ms,
                                       plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                                       library_ms=None))
        rows["K5"]["max_abs_err"] = max(errs)
        del e_req
        if not all(oks):
            raise AssertionError("K5 disagrees with its plain version")

    def kernel_k6():
        """On the inputs one flagship 'pallas' train step gives it (the
        embedding of 56,448 points, the loss's cotangents on (out, u)),
        under K3's two rules; then the frozen call (no weight gradient)."""
        args = k6_inputs.get("args") or step_bwd_inputs(torch, fs, dev, mode="pallas")
        e, tpack = args[0], args[1]
        n = e.shape[0]
        got, checks, oks = bwd_rules("K6", "pallas", args)
        again = FT.hand_trunk_sdf_u_bwd(*args)
        same = torch.equal(again[0], got[0]) and all(
            torch.equal(x, y) for x, y in zip(again[1], got[1]))
        frozen = FT.hand_trunk_sdf_u_bwd(*args, want_dw=False)
        frozen_ok = frozen[1] is None and torch.equal(frozen[0], got[0])
        # each call's CUDA graph (every launch, no trace to lose), with dW
        # as the control: the frozen call must launch K6's backward pair
        # and none of the dW / db kernels, and neither call a gemm_kernel
        before = FT.KERNEL_BWD.launches
        nodes = {want_dw: graph_kernel_nodes(
            torch, lambda: FT.hand_trunk_sdf_u_bwd(*args, want_dw=want_dw))
            for want_dw in (True, False)}
        launched = FT.KERNEL_BWD.launches - before == 2

        def count(want_dw, *keys):
            return sum(any(x in k for x in keys) for k in nodes[want_dw])

        dw_keys = ("gemm_tn", "colsum", "reduce_partials")
        dw_launches = count(False, *dw_keys)
        pair = ("hand_trunk_ut_kernel", "hand_trunk_dz_kernel")
        dw_seen = (launched and count(True, *dw_keys) > 0
                   and all(count(False, k) == count(True, k) > 0 for k in pair)
                   and count(False, "gemm_kernel") == count(True, "gemm_kernel") == 0)
        ms = cuda_ms(torch, lambda: FT.hand_trunk_sdf_u_bwd(*args), 5)
        frozen_ms = cuda_ms(torch, lambda: FT.hand_trunk_sdf_u_bwd(*args, want_dw=False), 5)
        plain_ms = cuda_ms(torch, lambda: FT.hand_trunk_sdf_u_plain_bwd(*args), 2)
        weights = [*tpack.ws, *tpack.bs]
        n_bytes = (4 * (3 * E + d_out) * n + nbytes(weights)
                   + 4 * sum(w.numel() for w in weights))
        b_ms, b_by = bound(k6_flops(sdf_cfg, n), n_bytes)
        log(f"K6 hand_trunk_sdf_u_bwd: {n} pts ({-(-n // FT.BWD_CHUNK)} passes); "
            f"{sum(oks)}/{len(oks)} comparisons within tolerance; a second run gives the same "
            f"bits: {same}; frozen call: the same de {frozen_ok}, dW/db launches "
            f"{dw_launches} of {len(nodes[False])} graph nodes (with dW "
            f"{count(True, *dw_keys)} of {len(nodes[True])}; the backward pair "
            f"{count(False, *pair)} and {count(True, *pair)}, gemm_kernel "
            f"{count(False, 'gemm_kernel')} and {count(True, 'gemm_kernel')}; the graphs show "
            f"them: {dw_seen}), {frozen_ms:.3f} ms; kernel {ms:.3f} ms, plain {plain_ms:.3f} "
            f"ms, bound {b_ms:.4f} ms ({b_by}, {k6_flops(sdf_cfg, n) / 1e12:.3f} TFLOP)")
        rows["K6"] = dict(rows.get("K6", {}), name=FT.KERNEL_BWD.name, route="cuda",
                          source=FT.KERNEL_BWD.source, replaces=FT.KERNEL_BWD.replaces,
                          max_abs_err=max(c.max_abs for c in checks), points=n, ms=ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=None)
        if not all(oks) or not same or not frozen_ok:
            raise AssertionError("K6 disagrees with its plain version")
        if not dw_seen or dw_launches:
            raise AssertionError("K6's frozen call: dW / db launches not shown absent")

    def kernel_nocolor():
        """K2 and K3 without the color net: the forward at a flagship
        'full_nocolor' step's points (56,448) and a request's (524,288)
        under the elementwise rule, the backward on the step's inputs
        under K3's two rules, and its frozen call."""
        args = step_bwd_inputs(torch, fs, dev, mode="full_nocolor")
        pack = args[4]
        n_step = args[0].shape[0]
        oks, fwd = [], {}
        for label, fargs, iters in (("step", args[:5], 5),
                                    ("request", (pts_all, rotT, off, cut, pack), 3)):
            n = fargs[0].shape[0]
            got = FF.hand_fine_color_fwd(*fargs)
            want = FF.hand_fine_color_plain(*fargs)
            torch.cuda.synchronize()
            checks = [compare(torch, what, a, b) for what, a, b in zip(("out", "g", "e"), got,
                                                                       want)]
            oks += [c[0] for c in checks]
            ms = cuda_ms(torch, lambda: FF.hand_fine_color_fwd(*fargs), iters)
            plain_ms = cuda_ms(torch, lambda: FF.hand_fine_color_plain(*fargs), 2)
            n_bytes = (12 * n + 4 * (d_out + 3 + E) * n
                       + nbytes([*fargs[1:4], *pack.ws, *pack.bs]))
            b_ms, b_by = bound(k5_flops(sdf_cfg, n), n_bytes)
            fwd[label] = (ms, plain_ms, b_ms)
            log(f"K2 no-color hand_fine_color_fwd, {label}: {n} pts; "
                f"{'; '.join(c[2] for c in checks)}; kernel {ms:.3f} ms, plain {plain_ms:.3f} "
                f"ms, bound {b_ms:.4f} ms ({b_by})")
        got, checks, b_oks = bwd_rules("K3 no-color", "full_nocolor", args)
        frozen = FF.hand_fine_color_bwd(*args, want_dw=False)
        frozen_ok = frozen.dws is None and all(
            torch.equal(getattr(frozen, k), getattr(got, k)) for k in ("dp", "drotT", "doff"))
        ms = cuda_ms(torch, lambda: FF.hand_fine_color_bwd(*args), 5)
        plain_ms = cuda_ms(torch, lambda: FF.hand_fine_color_plain_bwd(*args), 2)
        weights = [*pack.ws, *pack.bs]
        n_bytes = (nbytes([*args[:4], *args[5:], *weights]) + 12 * n_step
                   + 4 * sum(w.numel() for w in weights) + 4 * 9 * 128)
        b_ms, b_by = bound(k3_nocolor_flops(sdf_cfg, n_step), n_bytes)
        log(f"K3 no-color hand_fine_color_bwd: {n_step} pts; {sum(b_oks)}/{len(b_oks)} "
            f"comparisons within tolerance; frozen call: the same dp, drotT, doff {frozen_ok}; "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
        req = fwd["request"]
        rows["K2"] = dict(rows.get("K2", {}), nocolor_ms=req[0], nocolor_plain_ms=req[1],
                          nocolor_bound_ms=req[2])
        rows["K3"] = dict(rows.get("K3", {}), nocolor_ms=ms, nocolor_plain_ms=plain_ms,
                          nocolor_bound_ms=b_ms)
        if not all(oks + b_oks) or not frozen_ok:
            raise AssertionError("K2/K3 without the color net disagree with their plain versions")

    def train_pallas():
        launches = train_run("train pallas", "pallas", TRAIN_STEPS,
                             ("K1", "K5", "K6", "GEMM_TN", "EMBED", "COLSUM", "TFWD", "TUCH",
                              "COPY", "PACK", "TUT16", "TDZ16"), profile=True)
        for name in ("K5", "K6", "PACK"):
            rows.setdefault(name, {})["launches"] = launches[name]
        for name in ("TUT16", "TDZ16"):
            rows.setdefault(name, {})["pallas_launches"] = launches[name]
        rows.setdefault("COPY", {})["pallas_launches"] = launches["COPY"]

    def train_nocolor():
        launches = train_run("train full_nocolor", "full_nocolor", NOCOLOR_STEPS,
                             ("K1", "K2", "K3", "EMBED", "COLSUM", "TFWD", "TUCH", "BWDREV",
                              "COPY", "POSE", "TUT16", "TDZ16"), profile=True)
        for name in ("TUT16", "TDZ16"):
            rows.setdefault(name, {})["nocolor_launches"] = launches[name]
        rows.setdefault("COPY", {})["launches"] = launches["COPY"]
        rows.setdefault("K2", {})["nocolor_launches"] = launches["K2"]
        rows.setdefault("K3", {})["nocolor_launches"] = launches["K3"]
        rows.setdefault("BWDREV", {})["nocolor_launches"] = launches["BWDREV"]

    def serve_pallas():
        """One 4096-ray request through the eval render with
        train.fused_fine = 'pallas' (the served image's rays that meet the
        most surface, or its middle rows), timed beside the default mode on
        the same rays; the CHECK_RAYS rays of it that meet the most surface
        against the CPU render."""
        from honerf_torch.camera import full_image_ndc_grid

        render_p = make_hand_eval_render(sdf_cfg, color_cfg, rcfg,
                                         tcfg._replace(fused_fine="pallas"))
        grid = full_image_ndc_grid(H, W, device=dev)
        if "wsum" in served:
            rays = grid[torch.argsort(served["wsum"].reshape(-1), descending=True)[:REQUEST_RAYS]]
        else:
            rays = grid[(H * W - REQUEST_RAYS) // 2:][:REQUEST_RAYS]
        request = dict(view, rays_xy=rays)
        full_ms = []
        for fn in (render, render, render_p):   # the first calls pack the snapshot's weights
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(params, request)
            torch.cuda.synchronize()
            full_ms.append((time.perf_counter() - t0) * 1e3)
        for k in all_kernels.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        color, wsum = render_p(params, request)
        torch.cuda.synchronize()
        req_ms = (time.perf_counter() - t0) * 1e3
        launches = {name: k.launches for name, k in all_kernels.items()}
        log(f"serve pallas: one request of {REQUEST_RAYS} rays in {req_ms:.1f} ms "
            f"({REQUEST_RAYS / req_ms * 1e3:.1f} rays/s; the default 'full' mode on the same "
            f"rays {full_ms[1]:.1f} ms); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {launches}")
        assert bool(torch.isfinite(color).all()) and bool(torch.isfinite(wsum).all())
        # K1 and K5 in bf16: the fused trunk, no GEMM and no seed
        assert launches["K1"] and launches["K5"] and launches["TFWD"] and launches["TUCH"] and not (
            launches["K2"] or launches["K6"] or launches["BWDREV"] or launches["POSE"]
            or launches["GEMM"] or launches["UCHAIN"]), \
            f"the pallas render path launched {launches}"
        # one pack a K5 pass: a request's 524,288 fine points in 8 passes
        assert launches["PACK"] == 8 * launches["K5"] == 8, \
            f"the pallas request's packs: {launches['PACK']} for {launches['K5']} K5 calls"
        rows.setdefault("PACK", {})["request_launches"] = launches["PACK"]
        idx = torch.argsort(wsum.reshape(-1), descending=True)[:CHECK_RAYS]
        cpu = torch.device("cpu")
        c_ref, w_ref = render_p(clone_tree(params, cpu),
                                {k: v.to(cpu) for k, v in request.items()
                                 if k != "rays_xy"} | {"rays_xy": request["rays_xy"][idx].cpu()})
        ok = True
        for what, got, want in (("color", color[idx].cpu(), c_ref),
                                ("weight_sum", wsum[idx, 0].cpu(), w_ref[:, 0])):
            good, _, text = compare(torch, what, got, want, TOL_RENDER_MEDIAN, TOL_RENDER_MAX,
                                   scale=1.0)
            log(f"serve pallas: {CHECK_RAYS} rays vs the CPU render (plain versions), {text}")
            ok = ok and good
        log(f"serve pallas: their weight_sum {float(w_ref.min()):.4f}..{float(w_ref.max()):.4f}")
        assert ok, "the pallas render disagrees with the CPU render"

    phase("kernel K5", kernel_k5)
    phase("kernel K6", kernel_k6)
    phase("kernel K2/K3 no-color", kernel_nocolor)
    phase("train pallas", train_pallas)
    phase("train full_nocolor", train_nocolor)
    phase("train check pallas", lambda: train_check("pallas", "train check pallas"))
    phase("serve pallas", serve_pallas)

    # -- 26-31. the hand's offline stage with the conf's own f32 trunks ----
    from honerf_torch.camera import full_image_ndc_grid

    grid = full_image_ndc_grid(H, W, device=dev)
    if "wsum" in served:
        f32_rays = grid[torch.argsort(served["wsum"].reshape(-1), descending=True)[:REQUEST_RAYS]]
    else:
        f32_rays = grid[(H * W - REQUEST_RAYS) // 2:][:REQUEST_RAYS]
    run_f32_train_phases(torch, dev, phase, rows, failures, view, f32_rays,
                         (pts_all, rotT, off, cut))

    # -- 10-13. the object model: K4, its train step, the runner, meshes --
    obj = obj_flagship(torch, dev)
    log(f"conf {os.path.relpath(OBJ_CONF, ROOT)}: sdf {obj.sdf.n_layers}x{obj.sdf.d_hidden} skip "
        f"{obj.sdf.skip_in} embedding {obj.sdf.input_width} d_out {obj.sdf.d_out}; color "
        f"{obj.color.n_layers}x{obj.color.d_hidden} in {obj.color.input_width}; render "
        f"{obj.rcfg.n_samples}+{obj.rcfg.n_importance} up {obj.rcfg.up_sample_steps}; trunks f32")
    grid_pts = MESH_RES ** 3
    meshed = {}

    def kernel_k4():
        """A grid chunk of the mesh path, a ragged size, a million points,
        all in the obj-real mesh box, and the 256 calls of a 256^3 grid;
        each call one launch of obj_sdf_fused_kernel (the one node of the
        call's CUDA graph).  The bound: the
        larger of the tensor cores' (the sdf column's products) and the
        special-function units' (softplus's ex2 and lg2); the chunk's
        numbers go into the kernels line."""
        fused = FS.FusedObjSDF(obj.params["sdf"], obj.sdf)
        rng = np.random.default_rng(1)
        oks, errs = [], []
        peak_mufu, mhz = mufu_peak(torch)
        log(f"K4: {k4_flops(obj.sdf, 1.0) / 1e6:.4f} MFLOP and {k4_mufu_ops(obj.sdf, 1.0):.0f} "
            f"special-function operations a point; the special-function units' peak "
            f"{peak_mufu:.4e} a second ({MUFU_PER_CLOCK} a clock x "
            f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs x {mhz:.0f} MHz, "
            f"nvidia-smi clocks.max.sm)")
        for label, n in (("grid chunk", 1 << 16), ("ragged", (1 << 16) + 4321),
                         ("1M", 1 << 20)):
            pts = torch.as_tensor(rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32), device=dev)
            args = (pts, fused.ws, fused.bs, fused.meta)
            got = FS.fused_obj_sdf(*args)
            want = FS.fused_obj_sdf_plain(*args)
            torch.cuda.synchronize()
            ok, err, text = compare(torch, "sdf", got, want)
            # the call captured into a CUDA graph: one node, obj_sdf_fused_kernel
            nodes = graph_kernel_nodes(torch, lambda: FS.fused_obj_sdf(*args))
            launched = sum("obj_sdf_fused_kernel" in n for n in nodes)
            if launched != 1 or len(nodes) != 1:
                log(f"K4, {label}: the call's graph nodes {nodes or 'none'}")
            oks.append(ok and launched == 1 and len(nodes) == 1)
            errs.append(err)
            ms = cuda_ms(torch, lambda: FS.fused_obj_sdf(*args), 10)
            plain_ms = cuda_ms(torch, lambda: FS.fused_obj_sdf_plain(*args), 3)
            n_bytes = nbytes([pts, *fused.ws, *fused.bs]) + 4 * n
            tc_ms, _ = bound(k4_flops(obj.sdf, n), n_bytes)
            mufu_ms = k4_mufu_ops(obj.sdf, n) / peak_mufu * 1e3
            b_ms = max(tc_ms, mufu_ms)
            log(f"K4 obj_sdf_fused_kernel, {label}: {n} pts, {launched} launch (its CUDA graph); "
                f"{text}; kernel "
                f"{ms:.4f} ms ({ms * 1e6 / n:.3f} ms per M points), plain {plain_ms:.3f} ms; "
                f"bound {b_ms:.4f} ms (operations: tensor cores {tc_ms:.4f}, special-function "
                f"units {mufu_ms:.4f}): {b_ms / ms:.2f} of it")
            rows.setdefault("K4", dict(name=FS.KERNEL.name, route="cuda", source=FS.KERNEL.source,
                                       replaces=FS.KERNEL.replaces, points=n, ms=ms,
                                       plain_ms=plain_ms, bound_ms=b_ms, bound_by="operations",
                                       library_ms=None, tc_bound_ms=tc_ms, mufu_bound_ms=mufu_ms,
                                       sm_clock_mhz=mhz))
            if n == 1 << 16:   # a mesh's grid is 256 such chunks (the profiler can
                # miss a trace's first kernel: sixteen of them)
                device_profile(torch, "16 K4 grid chunks of 65,536 points",
                               lambda: [FS.fused_obj_sdf(*args) for _ in range(16)], points=n)
        # a 256^3 grid's K4 calls, as extract.evaluate_sdf_grid makes them
        chunk = 1 << 16
        pts = torch.as_tensor(rng.uniform(-0.2, 0.2, (chunk, 3)).astype(np.float32), device=dev)
        n_calls = grid_pts // chunk
        g_ms = cuda_ms(torch, lambda: [fused(pts) for _ in range(n_calls)], 3)
        g_tc = k4_flops(obj.sdf, grid_pts) / PEAK_BF16_FLOPS * 1e3
        g_mufu = k4_mufu_ops(obj.sdf, grid_pts) / peak_mufu * 1e3
        log(f"K4 per {MESH_RES}^3 grid ({n_calls} calls of {chunk} points): {g_ms:.2f} ms; "
            f"bound {max(g_tc, g_mufu):.2f} ms (tensor cores {g_tc:.2f}, special-function "
            f"units {g_mufu:.2f})")
        rows["K4"].update(max_abs_err=max(errs), grid_ms=g_ms, grid_bound_ms=max(g_tc, g_mufu))
        if not all(oks):
            raise AssertionError("K4 disagrees with its plain version or is not one launch")

    def obj_train():
        from honerf_torch.models.fields import init_se3_refine
        from honerf_torch.train.offline import make_obj_train_step

        ttcfg = obj.tcfg._replace(batch_size=TRAIN_RAYS, vgg_weight=0.0, refine_pose=True)
        tparams = dict(clone_tree(obj.params, dev),
                       se3_refine=init_se3_refine(8, "obj", device=dev))
        state = init_train_state(tparams, ttcfg)
        step = make_obj_train_step(obj.sdf, obj.color, obj.rcfg, ttcfg)
        batch = obj_train_batch(torch, TRAIN_RAYS, dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        se3_before = tparams["se3_refine"].detach().clone()
        torch.cuda.reset_peak_memory_stats()
        metrics = []
        for _ in range(TRAIN_WARMUP):
            state, m = step(state, batch, gen)
            metrics.append(m)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            state, m = step(state, batch, gen)
            metrics.append(m)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        loss = torch.stack([m["loss"] for m in metrics])
        gnorm = torch.stack([m["grad_norm"] for m in metrics])
        moved = float((tparams["se3_refine"].detach() - se3_before).abs().max())
        log(f"obj train: {TRAIN_STEPS} steps of {TRAIN_RAYS} rays in {dt * 1e3:.1f} ms: "
            f"{dt * 1e3 / TRAIN_STEPS:.2f} ms/step, {TRAIN_RAYS * TRAIN_STEPS / dt:.1f} rays/s "
            f"(host clock, after {TRAIN_WARMUP} warm-up steps); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"obj train: loss {', '.join(f'{x:.4f}' for x in loss.tolist())}")
        log(f"obj train: grad_norm first {float(gnorm[0]):.4f} last {float(gnorm[-1]):.4f}; "
            f"se3_refine moved by up to {moved:.3e}")
        assert bool(torch.isfinite(loss).all()) and bool(torch.isfinite(gnorm).all()), \
            "a loss or gradient norm is not finite"
        assert moved > 0, "se3_refine did not move"
        device_profile(torch, f"one object train step of {TRAIN_RAYS} rays",
                       lambda: step(state, batch, gen))

    def runner():
        """The object model through OfflineRunner: train, resume + test,
        meshes through K4."""
        import shutil
        import tempfile

        from honerf_torch.data.synthetic import generate_object_dataset
        from honerf_torch.train.runner import OfflineRunner, mesh_bounds

        tmp = tempfile.mkdtemp(prefix="chip_smoke_obj_")
        try:
            oH, oW = obj.conf.get_list("dataset.image_size")
            data = os.path.join(tmp, "data")
            generate_object_dataset(data, n_frames=1, n_views=2, H=oH, W=oW)
            conf = os.path.join(tmp, "bean.conf")
            with open(OBJ_CONF) as f:
                text = f.read().replace("./exp/CASE_NAME/wmask_realobj", os.path.join(tmp, "exp"))
            with open(conf, "w") as f:
                f.write(text.replace("./data/offline_stage_data/bean_cppose", data))
            r = OfflineRunner(conf, "train", "bean", device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.train(stop_at=10)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
            r.save_checkpoint_file()
            r2 = OfflineRunner(conf, "test", "bean", is_continue=True, device=dev)
            assert r2.iter_step == 10, r2.iter_step
            assert torch.equal(r2.state["params"]["sdf"]["layers"][0]["v"],
                               r.state["params"]["sdf"]["layers"][0]["v"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r2.test()
            torch.cuda.synchronize()
            test_s = time.perf_counter() - t0
            out_dir = os.path.join(tmp, "exp", "test_render")
            imgs = [read_png(os.path.join(out_dir, n)) for n in sorted(os.listdir(out_dir))]
            assert len(imgs) == 2 and all(i.shape == (oH, oW, 3) for i in imgs)
            fused = FS.FusedObjSDF(r2.state["params"]["sdf"], r2.sdf_cfg)
            lo, hi = mesh_bounds("obj", r2.data_type, np.zeros((21, 3)))
            probe = torch.as_tensor(np.stack([(lo + hi) / 2, hi]).astype(np.float32), device=dev)
            centre, corner = fused(probe).tolist()
            thr = 0.5 * (centre + corner)
            FS.KERNEL.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            recs = r2.validate_mesh(resolution=MESH_RES, threshold=thr)
            mesh_s = time.perf_counter() - t0
            launches = FS.KERNEL.launches
            rows["K4"] = dict(rows.get("K4", {}), launches=launches)
            log(f"runner: train(stop_at=10) in {train_s * 1e3:.1f} ms "
                f"({train_s * 1e3 / 10:.2f} ms/step); test: {len(imgs)} images of {oH}x{oW} in "
                f"{test_s * 1e3:.1f} ms ({test_s * 1e3 / len(imgs):.1f} ms per image); pixel "
                f"means {', '.join(f'{float(i.mean()):.2f}' for i in imgs)}")
            log(f"runner: field at the mesh box's centre {centre:.4f}, corner {corner:.4f}: "
                f"threshold {thr:.4f}; {len(recs)} meshes of {MESH_RES}^3 in {mesh_s * 1e3:.1f} ms, "
                f"K4 launches {launches}")
            for i, m in enumerate(recs):
                log(f"runner: mesh {i}: grid {m['grid_s'] * 1e3:.1f} ms, marching cubes "
                    f"{m['mc_s'] * 1e3:.1f} ms, PLY {m['ply_s'] * 1e3:.1f} ms; "
                    f"{m['n_verts']} vertices, {m['n_tris']} triangles")
            assert launches > 0, "K4 did not launch on the mesh path"
            assert all(m["n_verts"] > 0 and m["n_tris"] > 0 for m in recs), "an empty mesh"
            meshed.update(fused=fused, thr=thr, lo=lo, hi=hi, recs=recs)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)

    def mesh_check():
        from honerf_torch.extract import evaluate_sdf_grid, marching_cubes

        fused, thr, lo, hi, R = meshed["fused"], meshed["thr"], meshed["lo"], meshed["hi"], MESH_RES
        plain = lambda p: FS.fused_obj_sdf_plain(p, fused.ws, fused.bs, fused.meta)  # noqa: E731
        g_k, g_p = (evaluate_sdf_grid(fn, lo, hi, R, device=dev) for fn in (fused, plain))
        ok, _, text = compare(torch, "grid", torch.as_tensor(g_k, device=dev),
                              torch.as_tensor(g_p, device=dev))
        log(f"mesh check: the {R}^3 grid of K4 vs its plain version: {text}")
        (vk, tk), (vp, tp) = marching_cubes(g_k, thr), marching_cubes(g_p, thr)
        a = torch.as_tensor(vk, device=dev)
        b = torch.as_tensor(vp, device=dev)
        a, b = a.double(), b.double()  # f32 in cdist's matmul form loses ~0.1 voxel
        dist = torch.cat([torch.cdist(a[s:s + 4096], b).min(dim=1).values
                          for s in range(0, a.shape[0], 4096)])
        rel_v = abs(len(vk) - len(vp)) / max(len(vp), 1)
        rel_t = abs(len(tk) - len(tp)) / max(len(tp), 1)
        far = float(dist.max())
        log(f"mesh check: K4 mesh {len(vk)} vertices, {len(tk)} triangles; plain {len(vp)}, "
            f"{len(tp)} (differ by {rel_v:.2e}, {rel_t:.2e}; tol 1e-2); K4 vertex to the plain "
            f"mesh: median {float(dist.median()):.2e}, max {far:.2e} voxels (tol 1)")
        assert ok and rel_v <= 1e-2 and rel_t <= 1e-2 and far <= 1.0, \
            "the K4 mesh disagrees with the plain version's"
        # the mesh path's grid under the profiler: K4 is obj_sdf_fused_kernel
        # alone, one launch a chunk (the wrapper's count over the profiled
        # call; by name the profile must show it, at most once a chunk: late
        # in the process a trace can drop launches, PERF.md section 7), no
        # GEMM and no embedding kernel
        label = f"one {R}^3 K4 grid (extract.evaluate_sdf_grid)"
        before = FS.KERNEL.launches
        assert device_profile(torch, label,
                              lambda: evaluate_sdf_grid(fused, lo, hi, R, device=dev),
                              points=1 << 16) is not None, \
            "the mesh path's grid: the profiler recorded no device time"
        counted = FS.KERNEL.launches - before
        groups = PROFILES[label][0]
        k4 = [v for name, v in groups.items() if "obj_sdf_fused_kernel" in name]
        profiled = sum(v[1] for v in k4)
        stray = sorted(name for name in groups if "gemm" in name or "embed" in name)
        calls = -(-R ** 3 // (1 << 16))
        log(f"mesh check: the grid's K4 launches {counted} ({calls} chunks), "
            f"obj_sdf_fused_kernel {profiled} times in the profile, "
            f"{sum(v[0] for v in k4) / 1e3:.2f} ms of device time; GEMM or embedding kernels: "
            f"{stray or 'none'}")
        assert counted == calls and 0 < profiled <= calls and not stray, \
            "the mesh path's K4 is not one obj_sdf_fused_kernel launch a chunk"

    phase("kernel K4", kernel_k4)
    phase("obj train", obj_train)
    phase("runner", runner)
    if "runner" not in failures:
        phase("mesh check", mesh_check)
    else:
        failures.append("mesh check")

    run_fit_phases(torch, dev, phase, rows, failures)
    run_video_phases(torch, dev, phase, rows, failures, video_gen[0])

    wrong = log_perpoint_profiles()
    if wrong:
        log(f"per-point profiles: {wrong}")
        failures.append("per-point profiles")
    log(gpu_line())
    order = ("K1", "K2", "K3", "K4", "K5", "K6", "TFWD", "TUCH", "TFWD32", "TUCH32", "TUT32",
             "TDZ32", "TDW32", "CFWD32", "CBWD32", "CFWD16", "CBWD16", "TUT16", "TDZ16", "GEMM",
             "GEMM_TN", "GEMM_F32", "GEMM_TN_F32", "EMBED", "COLSUM", "UCHAIN", "BWDREV",
             "COPY", "PACK", "POSE")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    def mode_keys(prefix):
        return tuple(f"{prefix}{k}" for k in ("launches", "ms", "plain_ms", "bound_ms"))

    # each kernel's other modes: bf16 no-color, f32 with the color
    # net (K2 at a fit step and at a request; K3 frozen), f32 no-color, K3
    # f32 with dW, K5 / K6 in f32; the f32 GEMMs alone (rows of their own)
    # the fitting stage's launches: a video window step, a batched step, a
    # get_res frame
    extra = {"K1": ("video_launches", "get_res_launches"),
             "K2": (mode_keys("nocolor_") + mode_keys("f32_") + mode_keys("f32_nocolor_")
                    + mode_keys("f32_request_") + ("video_launches", "batched_launches")),
             "K3": (mode_keys("nocolor_") + mode_keys("f32_") + mode_keys("f32_nocolor_")
                    + mode_keys("f32_dw_") + ("video_launches", "batched_launches")),
             "K4": ("tc_bound_ms", "mufu_bound_ms", "grid_ms", "grid_bound_ms",
                    "get_res_launches"),
             "K5": mode_keys("f32_"), "K6": mode_keys("f32_"),
             "TFWD": ("train_launches", "step_ms", "step_plain_ms", "step_bound_ms", "k1_ms",
                      "k1_bound_ms", "k2_ms", "k2_bound_ms"),
             "TUCH": ("train_launches", "step_ms", "step_plain_ms", "step_bound_ms"),
             "TFWD32": (("f32_launches", "request_launches", "fit_launches", "worst_l2_f64",
                         "split_worst_l2_f64")
                        + tuple(f"{p}{k}" for p in ("step_", "pallas_", "fit_")
                                for k in ("ms", "bound_ms"))
                        + tuple(f"{p}pair_{k}" for p in ("request_", "step_", "pallas_", "fit_")
                                for k in ("ms", "split_ms", "bound_ms"))),
             "TUCH32": (("f32_launches", "request_launches", "fit_launches")
                        + tuple(f"{p}{k}" for p in ("step_", "pallas_", "fit_")
                                for k in ("ms", "bound_ms"))),
             "TUT32": (("f32_launches", "fit_launches", "worst_l2_f64", "split_worst_l2_f64")
                       + tuple(f"{p}{k}" for p in ("nocolor_", "pallas_", "fit_")
                               for k in ("ms", "bound_ms"))
                       + tuple(f"{p}chain_{k}" for p in ("step_", "nocolor_", "pallas_", "fit_")
                               for k in ("ms", "split_ms", "bound_ms"))),
             "TDZ32": (("f32_launches", "fit_launches")
                       + tuple(f"{p}{k}" for p in ("nocolor_", "pallas_", "fit_")
                               for k in ("ms", "bound_ms"))),
             "TDW32": (("f32_launches", "step_split_ms", "worst_l2_f64", "split_worst_l2_f64")
                       + tuple(f"{p}{k}" for p in ("nocolor_", "pallas_")
                               for k in ("ms", "split_ms", "bound_ms"))),
             "CFWD32": (("request_launches", "fit_launches", "step_split_ms", "worst_l2_f64",
                         "split_worst_l2_f64")
                        + tuple(f"{p}{k}" for p in ("request_", "fit_")
                                for k in ("ms", "split_ms", "bound_ms"))),
             "CBWD32": (("fit_launches", "step_split_ms", "worst_l2_f64", "split_worst_l2_f64")
                        + tuple(f"fit_{k}" for k in ("ms", "split_ms", "bound_ms"))),
             "CFWD16": (("image_launches", "request_launches", "train_launches", "step_split_ms",
                         "bits_moved")
                        + tuple(f"request_{k}" for k in ("ms", "split_ms", "bound_ms"))),
             "CBWD16": ("step_split_ms", "bits_moved"),
             "TUT16": (("pallas_launches", "nocolor_launches", "bits_moved")
                       + tuple(f"{p}{k}" for p in ("nocolor_", "pallas_")
                               for k in ("ms", "bound_ms"))
                       + tuple(f"{p}pair_{k}" for p in ("step_", "nocolor_", "pallas_")
                               for k in ("ms", "split_ms", "bound_ms"))),
             "TDZ16": (("pallas_launches", "nocolor_launches", "bits_moved")
                       + tuple(f"{p}{k}" for p in ("nocolor_", "pallas_")
                               for k in ("ms", "bound_ms"))),
             "COLSUM": ("f32_launches",),
             "GEMM_F32": ("pallas_launches", "request_launches"),
             "GEMM": ("image_launches", "request_launches", "train_launches"),
             "EMBED": ("train_launches", "step_ms", "step_bound_ms", "f32_ms", "f32_plain_ms",
                       "f32_bound_ms"),
             "UCHAIN": ("train_launches", "f32_train_launches", "fit_launches", "step_ms",
                        "step_bound_ms", "f32_ms", "f32_plain_ms", "f32_bound_ms",
                        "f32_library_ms", "fit_ms", "fit_bound_ms", "fit_library_ms"),
             "BWDREV": ("nocolor_launches", "f32_train_launches", "fit_launches", "fit_ms",
                        "fit_plain_ms", "fit_bound_ms"),
             "COPY": ("pallas_launches", "pallas_ms", "pallas_plain_ms", "pallas_bound_ms",
                      "pallas_library_ms"),
             "PACK": tuple(f"{p}{k}" for p in ("request_", "f32_", "fit_")
                           for k in ("launches", "ms", "plain_ms", "bound_ms", "library_ms")),
             "POSE": tuple(f"{p}{k}" for p in ("f32_", "fit_")
                           for k in ("launches", "ms", "plain_ms", "bound_ms", "library_ms"))}
    log(json.dumps({"kernels": [{k: rows.get(n, {}).get(k) for k in keys + extra.get(n, ())}
                                for n in order]}))
    if failures:
        log(f"chip_smoke: failed phases: {', '.join(failures)}")
        return 1
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
