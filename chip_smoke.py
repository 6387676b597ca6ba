#!/usr/bin/env python3
"""Drive the PyTorch port (smplfitter_tpu_torch) once on an NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one CUDA device, nvcc and PyTorch built for CUDA. It builds the kernels from
``smplfitter_tpu_torch/csrc``, then, on synthetic models at full width
(weights random from a seed): SMPL (V=6890, J=24, 10 betas, kid shapedir),
SMPL-X (V=10475, J=55, 16 betas, pose template F=487), SMPL+H ``smplh16``
(V=6890, J=52, 16 betas) and MANO (V=778, J=16, 10 betas):

 1. prints the toolchain (torch, CUDA, device, power limit, nvcc);
 2. builds the kernels and prints the build time;
 3. runs every kernel against its plain PyTorch twin on the operands the
    fitting paths give it (captured during forward passes, the benchmark fit
    and paths a-e below, on SMPL and on SMPL-X, the latter also with the kid
    column and joints) at B=4096 and at a ragged B=1000, asserting which
    wrappers each model's paths reach (CAPTURED), and times the kernel,
    the twin and, where one PyTorch call computes the same function, that
    call at B=4096; each kernel's least time on the card (its bound) is
    reckoned from the same operands, its blends counted at the operands'
    nonzero skinning weights; the kernels that have such a call (K7 and K8,
    the GEMMs of csrc/sgemm_tile.cuh) and the kernels that blend over each
    segment's active joints (K9, K6 in its three forms) also repeat bit for
    bit on the same operands, as do K1 and every form of K2, and a line
    gives K7's and K8's TFLOP/s beside the call's; K9 in scale modes 1 and
    2, K6's ω forms where no path reached them, on SMPL-X K9, K6, K1 and K2's
    cached forms with dense skinning weights (every joint on every vertex)
    and K9 and K2's cached forms at E = 32, on SMPL K2's emit form with
    dense weights, each held and timed the same way (hold_blend_variants),
    K6 beside the same function from K7 and K4's cached form, and K1 beside
    K7 on K1's own (feat, consts); and times each torch-op backward pass
    (TORCH_VJP_FORMS) at B=4096 on a captured call of its forward form.
    Every phase that drives a fitting path or the forward pass also fails
    if a wrapper built a vertex cover on the host (check_host_covers): K1,
    K2 and K9 walk the covers their models hold;
 4. makes 8 distinct SMPL target sets with ``BodyModel`` at B=4096;
 5. fits them with ``BodyFitter.fit`` (the benchmark configuration: num_iter=3,
    beta_regularizer=1, final rotation adjustment), checks that every kernel of
    the path was launched (K2 = K3 = K4 = 3 per fit) and reports fits/s;
 6. fits one B=32 target set on the card and on the CPU (the twins) and holds
    the two to max|d betas| <= 1e-3 and mean reconstruction error within 0.01 mm;
 7. drives the other fitting paths on the same 8 target sets, each with its
    launches per fit asserted and its fits/s: (a) ``fit`` without target
    joints, with the 'vertices' output; (b) the flipper's configuration:
    ``enable_kid``, no joints, warm start, one iteration; (c)
    ``fit_with_known_shape`` with joints; (d) ``fit_with_known_pose`` without
    joints; (e) ``fit(scale_fit=True)`` with joints;
 8. runs each of paths a-e at B=32 on the card and on the CPU under the gate
    of phase 6;
 9. SMPL-X: the forward pass at B=4096 makes 8 distinct target sets, the
    headline fit and paths a-e fit them, each with its launches per fit
    asserted (K7, K2 cached, K8 and K4 on the headline; K3 never) and fits/s;
10. SMPL-X's headline fit and paths a-e, and the SMPL+H and MANO headline
    fits, at B=32 on the card and on the CPU under the gate of phase 6, where
    the betas' limit is the larger of 1e-3 and a multiple of the fit's own
    spread (see SPREAD_MULT);
11. the fit-weight paths at B=4096, each with its launches per fit asserted
    and its fits/s (weights seeded uniform(0.1, 2.0)): (f) per-call vertex
    and joint weights in the headline configuration, on SMPL and SMPL-X; (g)
    per-call vertex weights without joints; (h) static vertex and joint
    weights with joints; (i) the hand replacer's call on SMPL+H (static
    vertex weights, 0.1 on the vertices whose dominant joint is a hand
    joint, no joints, num_iter=3, beta_regularizer=0, no final adjustment);
    (j) ``fit_with_known_pose`` and (k) ``fit_with_known_shape`` with
    per-call weights and joints; (l) static vertex weights without joints
    and ``scale_fit``, on SMPL and SMPL-X;
12. each of paths f-l at B=32 on the card and on the CPU under the gate of
    phase 10 (its own-spread limit on SMPL-X and SMPL+H);
13. runs every backward kernel (K10-K15 and their ω forms) against its plain
    twin on the operands of real backward passes (the gradient of the forward
    pass, of the headline and known-pose fits of the plain and the
    static-weight fitters, and of the CAPTURE_PATHS gradients: paths a, b, c
    and l, and c on the static-weight fitter; on SMPL, SMPL-X and MANO V=778,
    whose V % 256 = 10 puts a partial last vertex tile in every kernel) at
    B=4096 and B=1000, and K15's summed form on operands derived from the
    batched form's, asserting which kernels each model's gradients reach
    (BWD_CAPTURED), with times, twin times and bounds at B=4096; K10 and
    K14 (which walk a cover's and a part index's active-joint lists) also
    repeat bit for bit, and on SMPL-X are held and timed the same way with
    dense skinning weights (dense_bwd_variants);
14. the value and gradient at B=4096, with the fit's ms and the peak memory
    in the same call and the launches and torch-op backward passes
    (TORCH_VJPS) per gradient asserted: ``get_fit_grad_fn`` on the SMPL and
    SMPL-X headline and static-weight fits (K11 or K12 = 3, K13 = 3 besides
    the forward kernels), SMPL's known-pose fit (plain and static weights:
    K11's plain form once), each GRAD_PATHS path on SMPL and SMPL-X (K14 and
    K15 once per K6 and batched K5 launch; K2's scale forms, per-call ω and
    K9 in torch ops), and the forward pass's gradient;
15. the gradients at B=32 on the card against the CPU: the forward pass's
    within 1e-5 x max|g|, the SMPL headline fit's, every GRAD_PATHS path's on
    SMPL and the SMPL-X known-pose fit's (one solve through K7's, K12's and
    the streamed Gramian term's backward) within 1e-3 x max|g|, the
    static-weight, SMPL-X (also with one iteration and GRAD_PARITY_PATHS_X)
    and SMPL+H fits' within the larger of that and 4x the gradient's own
    spread (as phase 10: the rotation fits amplify rounding on the hand
    models).

It prints a JSON line of per-kernel results, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without a CUDA device it exits non-zero before doing anything.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 0
BATCH = 4096
RAGGED_BATCH = 1000
PARITY_BATCH = 32
N_TARGETS = 8
FIT_KW = dict(num_iter=3, beta_regularizer=1.0, final_adjust_rots=True,
              requested_keys=('pose_rotvecs', 'shape_betas', 'trans'))
KERNEL_REL_TOL = 1e-5  # max |kernel - twin| / max |twin| per output (see error_scales)
PARITY_DBETA = 1e-3
PARITY_V2V_MM = 0.01
# The synthetic hands' nearly degenerate finger parts amplify f32 rounding into
# the betas. Phase 10 therefore measures each fit's own spread: the largest
# change of its betas (kid, scale) over NOISE_SEEDS seeded changes of tv and tj
# by NOISE_REL relative, on the CPU and on the card alike. The card may differ
# from the CPU by no more than the larger of PARITY_DBETA and SPREAD_MULT times
# that spread; each line says whether PARITY_DBETA alone held. The multiple:
# a change of 1e-7 moves each target by about one ulp, while the card differs
# from the CPU in every sum (its kernels by up to ~6e-7 of max|twin|); on the
# known-pose fit, one linear solve with nothing to amplify, the card-vs-CPU
# gap measured 3.0x the spread on SMPL-X (H100, B=32).
NOISE_SEEDS = 3
NOISE_REL = 1e-7
SPREAD_MULT = 4
# Published peaks of one H100 SXM (dense, at 700 W): f32 on the CUDA cores and
# device memory bandwidth; a kernel's bound is the larger of its operations
# over the first and its bytes over the second.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# model -> (joints, betas, pose std of the synthetic targets)
MODELS = {'smpl': (24, 10, 0.3), 'smplx': (55, 16, 0.1), 'smplh16': (52, 16, 0.1),
          'mano': (16, 10, 0.1)}
# SMPL+H's hand joints: 15 per hand after the 22 body joints.
SMPLH_FIRST_HAND_JOINT = 22
HAND_WEIGHT = 0.1

# LAUNCHES key -> (wrapper, CUDA source, TPU kernel replaced, output names). The
# K2 forms share two wrappers: rhs_moments and rhs_moments_cached, whose
# ``scale`` argument picks the form.
SRC = 'smplfitter_tpu_torch/csrc/'
TPU = 'smplfitter_tpu/ops/lbs_kernels.py:'
KERNELS = {
    'lbs_points': ('lbs_points', SRC + 'lbs_points.cu', TPU + '771', ('points',)),
    'rhs_moments_h': ('rhs_moments_h', SRC + 'rhs_moments.cu', TPU + '525', ('r', 'y', 'homog')),
    'rhs_moments': ('rhs_moments', SRC + 'rhs_moments.cu', TPU + '525', ('r', 'y')),
    'rhs_moments_scale': ('rhs_moments', SRC + 'rhs_moments.cu', TPU + '525',
                          ('r', 'y', 'rt', 'yt', 'sc')),
    'rhs_moments_cached': ('rhs_moments_cached', SRC + 'rhs_moments.cu', TPU + '525', ('r', 'y')),
    'rhs_moments_cached_scale': ('rhs_moments_cached', SRC + 'rhs_moments.cu', TPU + '525',
                                 ('r', 'y', 'rt', 'yt', 'sc')),
    'gram_assembly': ('gram_assembly', SRC + 'gram_assembly.cu', TPU + '1819',
                      ('G', 'SA', 'rb', 'Sb')),
    'recon_part_sums_cached': ('recon_part_sums_cached_lm', SRC + 'recon_part_sums.cu',
                               TPU + '2808', ('raw', 's_t', 's_a')),
    'part_sums': ('part_sums_vm_lm', SRC + 'part_sums.cu', TPU + '832', ('raw', 's_t', 's_a')),
    'recon_part_sums': ('recon_part_sums_lm', SRC + 'recon_lbs_part_sums.cu', TPU + '1365',
                        ('raw', 's_t', 's_a')),
    'posed_template': ('posed_template_lm', SRC + 'posed_template.cu', TPU + '2523', ('homog',)),
    'term1': ('term1', SRC + 'term1.cu', TPU + '1884', ('G1',)),
    'wgram': ('wgram_moments', SRC + 'wgram.cu', TPU + '2190', ('G', 'SA', 'r', 'Sb', 'W')),
}
# The fit-weighted (ω) forms: the same wrapper, source and TPU kernel, their
# own launch count (the unweighted key + '_w').
WEIGHTED = ('rhs_moments_h', 'rhs_moments', 'rhs_moments_scale', 'rhs_moments_cached',
            'rhs_moments_cached_scale', 'recon_part_sums_cached', 'part_sums', 'recon_part_sums')
KERNELS.update({key + '_w': KERNELS[key] for key in WEIGHTED})
WRAPPERS = sorted({spec[0] for spec in KERNELS.values()})
# The keys each model's fitting paths reach (phase 3 asserts both sets). On
# SMPL-X the Gramian's wrapper streams through K8 and launches no K3; the
# per-call weighted solve runs K7 on every model.
SMPLX_ONLY = {'rhs_moments_cached', 'rhs_moments_cached_scale', 'term1',
              'rhs_moments_cached_w', 'rhs_moments_cached_scale_w'}
SMPL_ONLY = {'rhs_moments_h', 'rhs_moments', 'rhs_moments_scale', 'rhs_moments_h_w',
             'rhs_moments_w', 'rhs_moments_scale_w'}
CAPTURED = {'smpl': set(KERNELS) - SMPLX_ONLY, 'smplx': set(KERNELS) - SMPL_ONLY}
SCALE_FORM = {'rhs_moments': 'rhs_moments_scale',
              'rhs_moments_cached': 'rhs_moments_cached_scale'}

# The backward kernels (phases 13-15), as KERNELS: LAUNCHES key -> (wrapper,
# CUDA source, TPU kernel replaced, output names). K11 serves K2's emit-homog
# form (with the emitted template's cotangent); the ω forms count under '_w'.
BWD_KERNELS = {
    'lbs_points_bwd': ('lbs_points_bwd', SRC + 'lbs_points_bwd.cu', TPU + '1017',
                       ('dpj', 'dfeat')),
    'rhs_moments_h_bwd': ('rhs_moments_bwd', SRC + 'rhs_bwd.cu', TPU + '1140',
                          ('dtgt', 'dpj', 'dfeat')),
    'rhs_moments_bwd': ('rhs_moments_bwd', SRC + 'rhs_bwd.cu', TPU + '1140',
                        ('dtgt', 'dpj', 'dfeat')),
    'rhs_moments_cached_bwd': ('rhs_moments_cached_bwd', SRC + 'rhs_bwd.cu', TPU + '2593',
                               ('dtgt', 'dpj', 'dh')),
    'recon_part_sums_cached_bwd': ('recon_part_sums_cached_bwd', SRC + 'recon_bwd.cu',
                                   TPU + '2910', ('dtgt', 'dpj', 'dx', 'dh')),
    'recon_part_sums_bwd': ('recon_part_sums_bwd', SRC + 'recon_lbs_part_sums_bwd.cu',
                            TPU + '1462', ('dtgt', 'dpj', 'dfeat')),
    'part_sums_bwd': ('part_sums_bwd', SRC + 'part_sums_bwd.cu', TPU + '1665', ('dt', 'da')),
}
BWD_KERNELS.update({key + '_w': BWD_KERNELS[key] for key in
                    ('rhs_moments_h_bwd', 'rhs_moments_bwd', 'rhs_moments_cached_bwd',
                     'recon_part_sums_cached_bwd', 'recon_part_sums_bwd', 'part_sums_bwd')})
BWD_WRAPPERS = sorted({spec[0] for spec in BWD_KERNELS.values()})
# K15's summed form (a batch-constant reference, its cotangent summed over the
# batch): the API's form; no fitting path differentiates a batch-constant
# reference (the fit runs that case as one GEMM), so phase 13 holds it to its
# twin on operands derived from the batched form's (summed_calls) and it is
# left out of the launch checks and the kernels line.
SUMMED = {key.replace('part_sums_bwd', 'part_sums_bwd_sum'): BWD_KERNELS[key]
          for key in ('part_sums_bwd', 'part_sums_bwd_w')}
SPECS = {**KERNELS, **BWD_KERNELS, **SUMMED}
# The backward keys each model's gradients reach (phase 13 asserts them):
# the forward pass (K10), the headline fit, the known-pose fit (K11's plain
# form on the small-F models), the static-weight fitter's two (ω forms) and
# GRAD_PATHS' capture paths (K14, K15 and their ω forms).
BWD_CAPTURED = {
    'smpl': {'lbs_points_bwd', 'rhs_moments_h_bwd', 'rhs_moments_bwd',
             'recon_part_sums_cached_bwd', 'rhs_moments_h_bwd_w', 'rhs_moments_bwd_w',
             'recon_part_sums_cached_bwd_w', 'recon_part_sums_bwd', 'part_sums_bwd',
             'recon_part_sums_bwd_w', 'part_sums_bwd_w'},
    'smplx': {'lbs_points_bwd', 'rhs_moments_cached_bwd', 'recon_part_sums_cached_bwd',
              'rhs_moments_cached_bwd_w', 'recon_part_sums_cached_bwd_w', 'recon_part_sums_bwd',
              'part_sums_bwd', 'recon_part_sums_bwd_w', 'part_sums_bwd_w'},
    'mano': {'lbs_points_bwd', 'rhs_moments_h_bwd', 'rhs_moments_bwd',
             'recon_part_sums_cached_bwd', 'recon_part_sums_bwd', 'part_sums_bwd'},
}
N_GRAD_TARGETS = 4  # distinct target sets per value-and-gradient timing (phase 14)
GRAD_PARITY_REL = 1e-3  # card vs CPU, x max|g_cpu| (tests/test_tpu_grad.py's limit)
FWD_GRAD_PARITY_REL = 1e-5

# The other fitting paths (phases 7-10): the call on (fitter, fitter_kid,
# targets, params) and the kernel launches of one call, from the code, on SMPL
# (`launches`) and on the large-F models (`launches_x`: the posed template once
# per solve, K2's cached form, the Gramian through K8, and K4 wherever a solve
# hands its cache to a rotation fit with joints).
FLIP_KW = dict(num_iter=1, beta_regularizer=1e-2, beta_regularizer2=1e-2, kid_regularizer=1e9,
               final_adjust_rots=True, requested_keys=('pose_rotvecs',))
X_SOLVES = dict(posed_template=1, rhs_moments_cached=1, term1=1)


def _per_solve(n, **extra):
    return dict({k: v * n for k, v in X_SOLVES.items()}, **extra)


HEADLINE = dict(
    run=lambda f, fk, tv, tj, p: f.fit(tv, tj, **FIT_KW),
    launches=dict(rhs_moments_h=3, gram_assembly=3, recon_part_sums_cached=3),
    launches_x=_per_solve(3, recon_part_sums_cached=3))
PATHS = {
    'a_fit_no_joints': dict(
        run=lambda f, fk, tv, tj, p: f.fit(tv, num_iter=3, final_adjust_rots=True,
                                           requested_keys=('pose_rotvecs', 'vertices')),
        launches=dict(rhs_moments=3, gram_assembly=3, part_sums=3, lbs_points=4),
        launches_x=_per_solve(3, part_sums=3, lbs_points=4)),
    'b_flipper': dict(
        run=lambda f, fk, tv, tj, p: fk.fit(tv, initial_pose_rotvecs=p[0] + 0.05,
                                            initial_shape_betas=p[1] + 0.1,
                                            initial_kid_factor=p[3] + 0.1, **FLIP_KW),
        launches=dict(rhs_moments=1, gram_assembly=1, part_sums=2, lbs_points=2),
        launches_x=_per_solve(1, part_sums=2, lbs_points=2)),
    'c_known_shape': dict(
        run=lambda f, fk, tv, tj, p: f.fit_with_known_shape(p[1], tv, tj, num_iter=3,
                                                            final_adjust_rots=True),
        launches=dict(recon_part_sums=4),
        launches_x=dict(recon_part_sums=4)),
    'd_known_pose': dict(
        run=lambda f, fk, tv, tj, p: f.fit_with_known_pose(p[0], tv),
        launches=dict(rhs_moments=1, gram_assembly=1),
        launches_x=_per_solve(1)),
    'e_scale_fit': dict(
        run=lambda f, fk, tv, tj, p: f.fit(tv, tj, num_iter=3, scale_fit=True,
                                           final_adjust_rots=True),
        launches=dict(rhs_moments_h=2, rhs_moments_scale=1, gram_assembly=3,
                      recon_part_sums_cached=2, recon_part_sums=1),
        launches_x=dict(posed_template=3, rhs_moments_cached=2, rhs_moments_cached_scale=1,
                        term1=3, recon_part_sums_cached=3)),
}
# A fit with the kid column and target joints: K2 cached, K8 and K4 at E = 17.
KID_JOINTS = dict(run=lambda f, fk, tv, tj, p: fk.fit(tv, tj, num_iter=2, final_adjust_rots=True))

# The fit-weight paths (phases 11-12): the call on (fitters, targets, inputs),
# fitters a dict of the model's 'plain' fitter, 'static' (static vertex and
# joint weights) and 'static_vw' (static vertex weights; on SMPL+H the hand
# replacer's), inputs (pose, betas, trans, kid, vertex weights (B, V), joint
# weights (B, J)); the models it runs on; and its kernel launches per call,
# from the code. Per-call weights run K9 with K7 once per solve on every
# model, K5ω on the first rotation fit's T-pose and K4ω (joints) or K1 + K5ω
# (no joints) per later rotation fit; static weights keep the unweighted
# route with the ω forms of K2, K4 and K5.
HAND_KW = dict(num_iter=3, beta_regularizer=0.0, final_adjust_rots=False,
               requested_keys=('pose_rotvecs', 'shape_betas'))
WPATHS = {
    'f_call_weights': dict(
        run=lambda fs, tv, tj, p: fs['plain'].fit(tv, tj, vertex_weights=p[4],
                                                  joint_weights=p[5], **FIT_KW),
        models=('smpl', 'smplx'),
        launches=dict(part_sums_w=1, posed_template=3, wgram=3, recon_part_sums_cached_w=3)),
    'g_call_vw_no_joints': dict(
        run=lambda fs, tv, tj, p: fs['plain'].fit(tv, vertex_weights=p[4], num_iter=3,
                                                  final_adjust_rots=True),
        models=('smpl',),
        launches=dict(part_sums_w=4, posed_template=3, wgram=3, lbs_points=3)),
    'h_static_weights': dict(
        run=lambda fs, tv, tj, p: fs['static'].fit(tv, tj, **FIT_KW),
        models=('smpl',),
        launches=dict(rhs_moments_h_w=3, gram_assembly=3, recon_part_sums_cached_w=3)),
    'i_hand_replacer': dict(
        run=lambda fs, tv, tj, p: fs['static_vw'].fit(tv, **HAND_KW),
        models=('smplh16',),
        launches=dict(posed_template=3, rhs_moments_cached_w=3, term1=3, lbs_points=3,
                      part_sums_w=2)),
    'j_known_pose': dict(
        run=lambda fs, tv, tj, p: fs['plain'].fit_with_known_pose(
            p[0], tv, tj, vertex_weights=p[4], joint_weights=p[5]),
        models=('smpl',),
        launches=dict(posed_template=1, wgram=1)),
    'k_known_shape': dict(
        run=lambda fs, tv, tj, p: fs['plain'].fit_with_known_shape(
            p[1], tv, tj, vertex_weights=p[4], joint_weights=p[5], num_iter=3,
            final_adjust_rots=True),
        models=('smpl',),
        launches=dict(recon_part_sums_w=4, lbs_points=1)),
    'l_static_vw_scale_fit': dict(
        run=lambda fs, tv, tj, p: fs['static_vw'].fit(tv, num_iter=3, scale_fit=True,
                                                      final_adjust_rots=True),
        models=('smpl', 'smplx'),
        launches=dict(rhs_moments_w=2, rhs_moments_scale_w=1, gram_assembly=3, lbs_points=3,
                      part_sums_w=3),
        launches_x=dict(posed_template=3, rhs_moments_cached_w=2, rhs_moments_cached_scale_w=1,
                        term1=3, lbs_points=3, part_sums_w=3)),
}


RESULT_KEYS = ('shape_betas', 'trans', 'pose_rotvecs', 'kid_factor', 'scale_corr')


def result_loss(res):
    """The loss of the path gradients: the summed squares of a fit result's
    betas, translation, pose rotation vectors, kid factor and scale, where
    the result has them."""
    return sum((res[k] ** 2).sum() for k in RESULT_KEYS if k in res)


# The fitting paths made differentiable on the card by K14, K15 and the
# torch-op backward passes (phases 13-15): name -> the fitter key, the call on
# (fitters, targets, inputs) as WPATHS', the inputs differentiated, and the
# kernel launches and TORCH_VJPS counts of one value and gradient, from the
# code, on SMPL and on the large-F models (`_x`: the posed template, K2's
# cached form and K8, K4 where a solve hands its cache on). Fitters as in
# weighted_fitters, with 'kid' the kid fitter; inputs (pose, betas, trans,
# kid, vertex weights, joint weights). 'c_static' is (c) on the static-weight
# fitter: K6ω and K14ω. K14 and K15 launch once per K6 and batched K5 launch.
GRAD_PATHS = {
    'a_fit_no_joints': dict(
        fitter='plain', wrt=('tv',),
        run=lambda fs, tv, tj, p: PATHS['a_fit_no_joints']['run'](fs['plain'], None, tv, tj, p),
        launches=dict(PATHS['a_fit_no_joints']['launches'], part_sums_bwd=3, lbs_points_bwd=3,
                      rhs_moments_bwd=3),
        launches_x=dict(PATHS['a_fit_no_joints']['launches_x'], part_sums_bwd=3,
                        lbs_points_bwd=3, rhs_moments_cached_bwd=3)),
    'b_flipper': dict(
        fitter='kid', wrt=('tv',),
        run=lambda fs, tv, tj, p: PATHS['b_flipper']['run'](None, fs['kid'], tv, tj, p),
        launches=dict(PATHS['b_flipper']['launches'], part_sums_bwd=2, lbs_points_bwd=1,
                      rhs_moments_bwd=1),
        launches_x=dict(PATHS['b_flipper']['launches_x'], part_sums_bwd=2, lbs_points_bwd=1,
                        rhs_moments_cached_bwd=1)),
    'c_known_shape': dict(
        fitter='plain', wrt=('tv', 'tj'),
        run=lambda fs, tv, tj, p: PATHS['c_known_shape']['run'](fs['plain'], None, tv, tj, p),
        launches=dict(recon_part_sums=4, recon_part_sums_bwd=4),
        launches_x=dict(recon_part_sums=4, recon_part_sums_bwd=4)),
    'e_scale_fit': dict(
        fitter='plain', wrt=('tv', 'tj'),
        run=lambda fs, tv, tj, p: PATHS['e_scale_fit']['run'](fs['plain'], None, tv, tj, p),
        launches=dict(PATHS['e_scale_fit']['launches'], recon_part_sums_bwd=1,
                      recon_part_sums_cached_bwd=2, rhs_moments_h_bwd=2),
        launches_x=dict(PATHS['e_scale_fit']['launches_x'], recon_part_sums_cached_bwd=3,
                        rhs_moments_cached_bwd=2),
        vjps=dict(rhs_moments_scale=1), vjps_x=dict(rhs_moments_cached_scale=1)),
    'f_call_weights': dict(
        fitter='plain', wrt=('tv', 'tj', 'vw'), run=WPATHS['f_call_weights']['run'],
        launches=WPATHS['f_call_weights']['launches'],
        vjps=dict(recon_part_sums_cached_call_w=3, part_sums_call_w=1, wgram=3)),
    'k_known_shape': dict(
        fitter='plain', wrt=('tv', 'tj', 'vw'), run=WPATHS['k_known_shape']['run'],
        launches=dict(WPATHS['k_known_shape']['launches'], lbs_points_bwd=1),
        vjps=dict(recon_part_sums_call_w=4)),
    'c_static': dict(
        fitter='static', wrt=('tv', 'tj'),
        run=lambda fs, tv, tj, p: fs['static'].fit_with_known_shape(
            p[1], tv, tj, num_iter=3, final_adjust_rots=True),
        launches=dict(recon_part_sums_w=4, recon_part_sums_bwd_w=4)),
    'l_static_vw_scale_fit': dict(
        fitter='static_vw', wrt=('tv',), run=WPATHS['l_static_vw_scale_fit']['run'],
        launches=dict(WPATHS['l_static_vw_scale_fit']['launches'], part_sums_bwd_w=3,
                      lbs_points_bwd=3, rhs_moments_bwd_w=2),
        launches_x=dict(WPATHS['l_static_vw_scale_fit']['launches_x'], part_sums_bwd_w=3,
                        lbs_points_bwd=3, rhs_moments_cached_bwd_w=2),
        vjps=dict(rhs_moments_scale_w=1), vjps_x=dict(rhs_moments_cached_scale_w=1)),
}


# The kernels whose backward is torch ops in the JAX package's place (its XLA
# VJPs), counted in TORCH_VJPS under their LAUNCHES key.
TORCH_BWD_KERNELS = ('gram_assembly', 'posed_template', 'term1')


def grad_path_counts(name, model) -> tuple[dict, dict]:
    """(launches, TORCH_VJPS counts) of one value and gradient of a GRAD_PATHS
    path on a model. On these paths every input of K3, K7 and K8 follows the
    targets, so each of their launches has its torch-op backward."""
    path = GRAD_PATHS[name]
    x = '_x' if model != 'smpl' else ''
    launches = path.get('launches' + x, path['launches'])
    vjps = dict(path.get('vjps' + x, path.get('vjps', {})))
    vjps.update({k: launches[k] for k in TORCH_BWD_KERNELS if launches.get(k)})
    return launches, vjps


# The SMPL-X paths of phase 15 (each under the spread rule; SMPL runs them all):
# K14 at F=503, K15ω, and the torch-op backward passes of per-call weights.
GRAD_PARITY_PATHS_X = ('b_flipper', 'c_known_shape', 'f_call_weights', 'l_static_vw_scale_fit')
# The paths whose gradients phase 13 and the CPU tests capture operands from.
CAPTURE_PATHS = ('a_fit_no_joints', 'b_flipper', 'c_known_shape', 'c_static',
                 'l_static_vw_scale_fit')


def path_vg(torch, name, fitters, p):
    """``vg(tv, tj) -> (value, grads)``: result_loss of GRAD_PATHS[name]'s
    call with the inputs ``p`` and its gradient in the inputs the path
    differentiates (tv, tj, the vertex weights), on the targets' device."""
    run, wrt = GRAD_PATHS[name]['run'], GRAD_PATHS[name]['wrt']

    def vg(tv, tj):
        dev = tv.device
        q = [x if x is None else x.to(dev) for x in p]
        leaves = dict(tv=tv.detach().requires_grad_(), tj=tj.detach().requires_grad_(),
                      vw=None if q[4] is None else q[4].detach().requires_grad_())
        q[4] = leaves['vw']
        with torch.enable_grad():
            loss = result_loss(run(fitters, leaves['tv'], leaves['tj'], tuple(q)))
            grads = torch.autograd.grad(loss, [leaves[k] for k in wrt])
        return loss.detach(), grads
    return vg


def wpath_launches(path, model) -> dict:
    return path.get('launches_x', path['launches']) if model != 'smpl' else path['launches']


def fit_weights(torch, rng, batch, n, device):
    """Seeded per-call fit weights (batch, n), uniform in [0.1, 2)."""
    return torch.as_tensor(rng.uniform(0.1, 2.0, (batch, n)).astype(np.float32), device=device)


def weighted_fitters(port, bm, model, rng, plain) -> dict:
    """The fitters of the weighted paths for one model: plain, with static
    vertex and joint weights (seeded), and with static vertex weights (on
    SMPL+H the hand replacer's: 0.1 where the dominant joint is a hand's)."""
    V, J = bm.num_vertices, bm.num_joints
    vw = rng.uniform(0.1, 2.0, V).astype(np.float32)
    jw = rng.uniform(0.1, 2.0, J).astype(np.float32)
    if model == 'smplh16':
        dominant = np.argmax(np.asarray(bm.model_data.weights), axis=1)
        vw = np.where(dominant >= SMPLH_FIRST_HAND_JOINT, HAND_WEIGHT, 1.0).astype(np.float32)
    return dict(plain=plain,
                static=port.BodyFitter(bm, vertex_weights=vw, joint_weights=jw),
                static_vw=port.BodyFitter(bm, vertex_weights=vw))


def cpu_path_fitters(port, cpu_bm, fitters) -> dict:
    """CPU copies, on the CPU model ``cpu_bm``, of a dict of fitters (the
    same kid column and static weights)."""
    return {key: port.BodyFitter(cpu_bm, enable_kid=f.enable_kid, vertex_weights=f.static_vw,
                                 joint_weights=f.static_jw) for key, f in fitters.items()}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_params(rng, batch, model='smpl'):
    J, S, pose_std = MODELS[model]
    pose = rng.normal(0, pose_std, (batch, 3 * J)).astype(np.float32)
    betas = rng.normal(0, 1, (batch, S)).astype(np.float32)
    trans = rng.normal(0, 0.5, (batch, 3)).astype(np.float32)
    return pose, betas, trans


def kid_factors(rng, batch):
    return rng.normal(0, 0.5, (batch,)).astype(np.float32)


def record_calls(lbs_kernels, wrappers, run, key_of=lambda name, kwargs: name) -> dict:
    """Run ``run()`` with the named wrappers of ``lbs_kernels`` recording their
    arguments: {key_of(wrapper, kwargs): [(args, kwargs), ...]} (empty lists
    for keys never called)."""
    calls = collections.defaultdict(list)
    originals = {name: getattr(lbs_kernels, name) for name in wrappers}

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            calls[key_of(name, kwargs)].append((args, kwargs))
            return fn(*args, **kwargs)
        return wrapped

    try:
        for name, fn in originals.items():
            setattr(lbs_kernels, name, recorder(name, fn))
        run()
    finally:
        for name, fn in originals.items():
            setattr(lbs_kernels, name, fn)
    return calls


FWD_KEY = {spec[0]: key for key, spec in KERNELS.items()
           if key not in SCALE_FORM.values() and not key.endswith('_w')}


def kernel_key(wrapper: str, kwargs) -> str:
    """The LAUNCHES key of a forward wrapper's call."""
    key = SCALE_FORM[wrapper] if kwargs.get('scale') else FWD_KEY[wrapper]
    return key + ('_w' if kwargs.get('omega') is not None else '')


def same_configuration(kw_a, kw_b) -> bool:
    """Two calls' keyword arguments agree (tensors by shape)."""
    if kw_a.keys() != kw_b.keys():
        return False
    return all(_config(kw_a[k]) == _config(kw_b[k]) for k in kw_a)


def _config(x):
    """A keyword argument by its shape: a tensor's, a segment cover's lists'."""
    if hasattr(x, 'joint_offset'):
        return ('cover', x.verts.shape, x.joints.shape)
    return getattr(x, 'shape', x)


def error_scales(torch, lbs_kernels, key, args, want) -> list:
    """The scale each output's error is held to: max|twin|, except for two
    outputs of K9 that cancel by construction. SA sums a Jacobian centred by
    its own weighted mean (zero up to rounding) and r a product with
    residuals of either sign; they are held to the Cauchy-Schwarz bounds of
    their terms, max sqrt(W G_ee) and max sqrt(G_ee sum ω |b|^2)."""
    scales = [w.abs().max().item() for w in want]
    if key == 'wgram':
        G, _, r, _, W = want
        E1 = r.shape[0]
        diag = G.reshape(E1, E1, -1).diagonal(dim1=0, dim2=1)  # (B, E1)
        tgt, pj, homog, _, w, _, _, om = args[:8]
        V = om.shape[0]
        pos = lbs_kernels._apply_blend(torch.einsum('vj,xjb->xvb', w[:V], pj), homog[:, :V])
        bb = (((tgt - pos) ** 2).sum(dim=0) * om).sum(dim=0)  # (B,)
        scales[1] = (W[0][:, None] * diag).sqrt().max().item()
        scales[2] = (diag * bb[:, None]).sqrt().max().item()
    return scales


def kernel_call(lbs_kernels, key, args, kwargs):
    out = getattr(lbs_kernels, SPECS[key][0])(*args, **kwargs)
    return out if isinstance(out, tuple) else (out,)


def twin_call(lbs_kernels, key, args, kwargs):
    return lbs_kernels.twin_call(SPECS[key][0], args, kwargs)


# Besides the kernels with a library call (K7, K8), the kernels redesigned
# for Hopper (K9, K6, K1, every form of K2, K10 and K14) also repeat bit for
# bit on the same operands.
K2_KEYS = ('rhs_moments_h', 'rhs_moments', 'rhs_moments_scale', 'rhs_moments_cached',
           'rhs_moments_cached_scale')
REPEAT_KEYS = ('wgram', 'recon_part_sums', 'recon_part_sums_w', 'lbs_points', *K2_KEYS,
               *(key + '_w' for key in K2_KEYS), 'lbs_points_bwd', 'recon_part_sums_bwd',
               'recon_part_sums_bwd_w')


def library_call(torch, key):
    """One PyTorch call computing the same function as the kernel (timed as a
    yardstick, never used by the port), or None where there is none."""
    if key == 'posed_template':
        return lambda feat, consts: torch.matmul(consts[:3], feat)
    if key == 'term1':  # the einsum that forms X, then the product
        return lambda R, ksd: ksd.T @ torch.einsum('ajb,akb->jkb', R, R).reshape(-1, R.shape[2])
    return None


def skinned(w, rows=None) -> float:
    """The (vertex, joint) pairs with a nonzero skinning weight among the
    vertices a kernel blends (``rows``: a vertex count or index list; all of
    ``w``'s rows by default): a blend of per-joint entries needs one FMA per
    entry for each of them, not one per joint."""
    if rows is not None:
        w = w[:rows] if isinstance(rows, int) else w[rows.long()]
    return float((w != 0).sum().item())


def kernel_work(key, args, kwargs=None) -> tuple[float, float]:
    """(operations, bytes) that the kernel's function needs on these operands:
    each input read once and each output written once; the per-part kernels
    count only the vertices that belong to a part. Blends over the joints
    count the nonzero skinning weights of these operands (``skinned``). A
    fit-weighted form adds its weights' bytes and one multiply per weighted
    term."""
    n = lambda t: float(t.numel())  # noqa: E731
    kwargs = kwargs or {}
    if key in BWD_KERNELS or key in SUMMED:
        return backward_work(key, args, kwargs)
    if key.endswith('_w'):
        flops, nbytes = kernel_work(key[:-2], args)
        om = kwargs['omega']
        pts = args[0].shape[1] * args[0].shape[2]  # target rows x columns
        parts = next((a for a in args if hasattr(a, 'verts')), None)
        rows = om.shape[0] if parts is None else float(parts.verts.numel())
        return flops + 2.0 * 4 * pts, nbytes + 4 * rows * om.shape[1]
    if key == 'wgram':
        tgt, pj, homog, t4, w, sd, mu, om = args[:8]
        _, J, B = pj.shape
        V, E = om.shape[0], sd.shape[2]
        E1 = E + (1 if kwargs.get('scale_mode') else 0)
        pairs = E1 * (E1 + 1) // 2
        per = 9 * E + 9 + 4 * pairs + 7 * E1 + 4
        blend = (12 + 3 * E) * skinned(w, V)
        ins = 7 * V * B + n(pj) + n(t4) + V * J + 3 * V * E + n(mu)
        return 2.0 * B * (V * per + blend), 4 * (ins + (E1 * E1 + 4 * E1 + 4) * B)
    if key == 'lbs_points':
        pj, feat, w, consts = args
        _, J, B = pj.shape
        F, Vp = feat.shape[0], w.shape[0]
        return (2.0 * B * (Vp * (3 * F + 12) + 12 * skinned(w)),
                4 * (n(pj) + n(feat) + n(w) + 3 * Vp * F + 3 * Vp * B))
    if key.startswith('rhs_moments'):
        cached = key.startswith('rhs_moments_cached')
        scale = key.endswith('_scale')
        tgt, pj = args[0], args[1]
        w, sd = (args[3], args[4]) if cached else (args[3], args[5])
        _, J, B = pj.shape
        Vp, E = w.shape[0], sd.shape[2]
        F = 0 if cached else args[2].shape[0]
        per = 3 * F + 12 + 3 + 9 + 3 * E
        per_joint = 12 + 3
        if scale:
            per += 9 + 3 * E + 3
            per_joint += 3
        ins = n(tgt) + n(pj) + n(w) + n(sd) + (n(args[2]) if cached else n(args[2]) + 3 * Vp * F)
        outs = (3 * J + E) * B * (2 if scale else 1) + (3 * B if scale else 0)
        outs += 3 * Vp * B if key == 'rhs_moments_h' else 0
        return 2.0 * B * (Vp * per + per_joint * skinned(w)), 4 * (ins + outs)
    if key == 'posed_template':
        feat, consts = args
        F, B = feat.shape
        Vp = consts.shape[1]
        return 2.0 * 3 * Vp * F * B, 4 * (n(feat) + 3 * Vp * F + 3 * Vp * B)
    if key == 'term1':
        R, ksd = args
        _, J3, B = R.shape
        EE = ksd.shape[1]
        return 2.0 * B * J3 * J3 * (EE + 3), 4 * (n(R) + n(ksd) + EE * B)
    if key == 'gram_assembly':
        R, T, y, P, bJ, ksd, lz, sd1, q, w1 = args
        _, J3, B = R.shape
        E = sd1.shape[1]
        J = J3 // 3
        per = (J3 * J3 * (E * E + 3) + 3 * J3 * E * J + 3 * E * E * J * 3 + 3 * E * J * J
               + 3 * J3 * E + 6 * E * J)
        outs = (E * E + 3 * E + E + 3) * B
        return 2.0 * B * per, 4 * (sum(n(a) for a in args) + outs)
    # per-part kernels: the used vertices of the part index
    parts = next(a for a in args if hasattr(a, 'verts'))
    Vu = float(parts.verts.numel())
    if key == 'part_sums':
        t, a = args[0], args[1]
        J, B = parts.pm.shape[0], t.shape[2]
        return Vu * B * 24, 4 * (3 * Vu * (B + a.shape[2]) + 15 * J * B)
    tgt, pj = args[0], args[1]
    _, J, B = pj.shape
    if key == 'recon_part_sums_cached':
        x, sd, homog, _, w = args[2:]
        E = x.shape[0]
        per = 3 * E + 3 + 12 + 15
        return (2.0 * B * (Vu * per + 12 * skinned(w, parts.verts)),
                4 * (6 * Vu * B + n(pj) + n(x) + Vu * (3 * E + J) + 15 * J * B))
    feat, w, consts = args[2], args[3], args[4]  # recon_part_sums
    F = feat.shape[0]
    per = 3 * F + 12 + 15
    return (2.0 * B * (Vu * per + 12 * skinned(w, parts.verts)),
            4 * (3 * Vu * B + n(pj) + n(feat) + Vu * (J + 3 * F) + 15 * J * B))


def backward_work(key, args, kwargs) -> tuple[float, float]:
    """(operations, bytes) of a backward kernel's function on these operands:
    the least work its formula needs, not the kernel's own recomputation. Per
    (vertex, column), in FMAs, with J the joints that skin the vertex (its
    nonzero weights, ``skinned``): the blended [R|t] formed once (12J, or 9J
    where only its rotation is used), the 12 dpj fields reduced over the
    joints (12J), K11/K12's gy term (3J), the posed template and the feature
    reduction (3F each, K10/K11), G = SD gr or SD x and the shape reduction
    (3E each), and per-vertex constants: each 3 x 3 product with the formed
    blend (9: the position, blend . G, Rbar^T of a field), K13's two 3 x 3
    products with the part's cotangents (18), the 9 dpj field products (9)
    and the residual (3). K13, K14 and K15 count the vertices that belong to
    a part (the others add nothing but their zeros): K14 per = 6F + 24J + 45
    (the template and dfeat 6F, blend and dpj 24J, position and Rbar^T dpos
    18, dtgt and dpos 18, dpj products 9), K15 per = 18 (dt and da). Inputs
    read once, outputs written once; ω adds its column and 6 multiplies (3
    FMAs' worth)."""
    n = lambda t: float(t.numel())  # noqa: E731
    omega = kwargs.get('omega')
    w_ops = 3 if omega is not None else 0
    if key.startswith('part_sums_bwd'):
        graw, gst, gsa, t, a, parts = args
        _, v_t, B = t.shape
        Vu = float(parts.verts.numel())
        ins = n(graw) + n(gst) + n(gsa) + 3 * (min(Vu, v_t) * B + min(Vu, a.shape[1]) * a.shape[2])
        ins += omega.shape[0] if omega is not None else 0
        return 2.0 * Vu * B * (18 + w_ops), 4 * (ins + n(t) + n(a))
    if key.startswith('recon_part_sums_bwd'):
        graw, gst, gsa, tgt, pj, feat, w, consts, parts = args
        _, J, B = pj.shape
        F = feat.shape[0]
        Vu = float(parts.verts.numel())
        ins = n(graw) + n(gst) + n(gsa) + 3 * min(Vu, tgt.shape[1]) * B + n(pj) + n(feat)
        ins += Vu * (J + 3 * F) + (omega.shape[0] if omega is not None else 0)
        outs = n(tgt) + (12 * J + F) * B
        return (2.0 * B * (Vu * (6 * F + 45 + w_ops) + 24 * skinned(w, parts.verts)),
                4 * (ins + outs))
    if key.startswith('lbs_points_bwd'):
        g, pj, feat, w, consts = args
        _, J, B = pj.shape
        F, Vp = feat.shape[0], w.shape[0]
        return (2.0 * B * (Vp * (6 * F + 9) + 21 * skinned(w)),
                4 * (n(g) + n(pj) + n(feat) + n(w) + 3 * Vp * F + (12 * J + F) * B))
    if key.startswith('recon_part_sums_cached_bwd'):
        graw, gst, gsa, tgt, pj, x, sd, homog, parts, w = args
        _, J, B = pj.shape
        E, Vp = x.shape[0], w.shape[0]
        Vu = float(parts.verts.numel())
        # blend 12J, dpj 12J, SD x and dx 6E, position and Rbar^T dpos 18,
        # dtgt and dpos from the part's cotangents 18, dpj products 9
        per = 6 * E + 45 + (3 if omega is not None else 0)
        ins = n(graw) + n(gst) + n(gsa) + 3 * min(Vu, tgt.shape[1]) * B + n(pj) + n(x)
        ins += Vu * (3 * E + J) + 3 * Vu * B + (Vp if omega is not None else 0)
        outs = n(tgt) + (12 * J + E) * B + 3 * Vp * B
        return 2.0 * B * (Vu * per + 24 * skinned(w, parts.verts)), 4 * (ins + outs)
    cached = key.startswith('rhs_moments_cached_bwd')
    gr, gy, tgt, pj = args[:4]
    w, sd = (args[5], args[6]) if cached else (args[5], args[7])
    _, J, B = pj.shape
    Vp, E = w.shape[0], sd.shape[2]
    F = 0 if cached else args[4].shape[0]
    # blend 12J, gy term 3J, dpj 12J, template and dfeat 6F, G 3E, position,
    # blend . G and Rbar^T db 27, dpj products 9, residual 3
    per = 6 * F + 3 * E + 39 + (3 if omega is not None else 0)
    ins = n(gr) + n(gy) + n(tgt) + n(pj) + n(w) + n(sd) + (Vp if omega is not None else 0)
    ins += 3 * Vp * B if cached else n(args[4]) + 3 * Vp * F
    ins += 3 * Vp * B if kwargs.get('gh') is not None else 0
    outs = n(tgt) + 12 * J * B + (3 * Vp * B if cached else F * B)
    return 2.0 * B * (Vp * per + 27 * skinned(w)), 4 * (ins + outs)


def bound(key, args, kwargs=None) -> tuple[float, str]:
    flops, nbytes = kernel_work(key, args, kwargs)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, 'operations' if t_ops >= t_bytes else 'bytes'


def check_host_covers(lbs_kernels, what: str) -> None:
    """No wrapper call since the counts were last reset built a vertex cover
    on the host: every call of the fitting paths passes its model's."""
    built = {k: n for k, n in lbs_kernels.HOST_COVERS.items() if n}
    if built:
        raise AssertionError(f'{what}: covers built on the host for {built}')


def check_launches(launches: dict, expected_per_fit: dict, n_fits: int, what: str) -> None:
    """Every kernel's launch count must be its expected count per fit times n_fits."""
    for key, n in launches.items():
        want = expected_per_fit.get(key, 0) * n_fits
        if n != want:
            raise AssertionError(f'{what}: {key} launched {n} times in {n_fits} fits, '
                                 f'expected {want}')


def time_ms(torch, fn, arg_sets) -> float:
    """Median device time of fn over distinct argument sets (after a warm-up)."""
    fn(*arg_sets[0])
    times = []
    for args in arg_sets:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def recon_v2v_mm(bm, res, tv) -> float:
    """Mean distance (mm) of a fit result's reconstruction to the targets tv."""
    dev = tv.device
    re = bm(glob_rotmats=res['orientations'].to(dev), shape_betas=res['shape_betas'].to(dev),
            trans=res['trans'].to(dev),
            kid_factor=None if 'kid_factor' not in res else res['kid_factor'].to(dev))
    return (re['vertices'] - tv).norm(dim=-1).mean().item() * 1e3


def check_kernels(torch, lbs_kernels, label, make_run, dev, rng, kid_rng, model) -> dict:
    """Phase 3 for one model: capture the kernels' operands from ``make_run``'s
    fitting paths at B=4096 and B=1000, hold every kernel to its twin, and at
    B=4096 time kernel, twin and library call and reckon the bound."""
    results = {}
    for batch in (BATCH, RAGGED_BATCH):
        params = [random_params(rng, batch, model) for _ in range(3)]
        kid = torch.as_tensor(kid_factors(kid_rng, batch), device=dev)
        lbs_kernels.reset_launch_counts()
        calls = record_calls(lbs_kernels, WRAPPERS, make_run(params, kid), kernel_key)
        check_host_covers(lbs_kernels, f'{label} at B={batch}')
        captured = {key for key, arg_sets in calls.items() if arg_sets}
        if captured != CAPTURED[model]:
            raise AssertionError(f'{label} at B={batch}: the paths reached {sorted(captured)}, '
                                 f'expected {sorted(CAPTURED[model])}')
        if 'term1' in captured:  # the Gramian streamed: K8, and no K3 launch
            if lbs_kernels.LAUNCHES['gram_assembly'] or not lbs_kernels.LAUNCHES['term1']:
                raise AssertionError(f'{label} at B={batch}: the Gramian launched K3 '
                                     f'{lbs_kernels.LAUNCHES["gram_assembly"]} times and K8 '
                                     f'{lbs_kernels.LAUNCHES["term1"]} times')
            captured.remove('gram_assembly')
        if model == 'smplx' and 17 not in {a[2].shape[0] for a, _ in
                                           calls['recon_part_sums_cached']}:
            raise AssertionError(f'{label} at B={batch}: K4 saw no operands with E = 17')
        for key in [k for k in KERNELS if k in captured]:
            hold_to_twin(torch, lbs_kernels, label, key, calls[key], batch, results)
        hold_blend_variants(torch, lbs_kernels, label, calls, batch,
                            results.setdefault('variants', {}), model)
        if batch == BATCH:
            for key in TORCH_VJP_FORMS:
                time_torch_vjp(torch, lbs_kernels, label, key, calls,
                               results.setdefault('torch_vjp_ms', {}))
        del calls
        torch.cuda.empty_cache()
    return results


def hold_to_twin(torch, lbs_kernels, label, key, arg_sets, batch, results) -> None:
    """Hold every captured call of one kernel to its twin (KERNEL_REL_TOL of
    its error scale per output), and a kernel with a library call to its own
    second call, bit for bit; at B=4096 also time kernel, twin and library
    call over the calls of the first call's configuration and reckon the
    bound. Without autograd: captured backward operands may carry history."""
    with torch.no_grad():
        res = results.setdefault(key, dict(max_abs_err=0.0, rel_err={}))
        outputs = SPECS[key][3]
        repeat = library_call(torch, key) is not None or key in REPEAT_KEYS
        for args, kwargs in arg_sets:
            got = kernel_call(lbs_kernels, key, args, kwargs)
            want = twin_call(lbs_kernels, key, args, kwargs)
            again = kernel_call(lbs_kernels, key, args, kwargs) if repeat else got
            torch.cuda.synchronize()
            if not all(torch.equal(g, a) for g, a in zip(got, again, strict=True)):
                raise AssertionError(f'{label} {key} at B={batch}: two calls on the same '
                                     'operands differ')
            scales = error_scales(torch, lbs_kernels, key, args, want)
            for out_name, g, w, scale in zip(outputs, got, want, scales, strict=True):
                abs_err = (g - w).abs().max().item()
                rel = abs_err / scale if scale > 0 else abs_err
                if not (rel <= KERNEL_REL_TOL and torch.isfinite(g).all().item()):
                    raise AssertionError(
                        f'{label} {key}.{out_name} at B={batch}: max|kernel - twin| = '
                        f'{abs_err:.3e} = {rel:.3e} x its scale > {KERNEL_REL_TOL}')
                res['max_abs_err'] = max(res['max_abs_err'], abs_err)
                res['rel_err'][out_name] = max(res['rel_err'].get(out_name, 0.0), rel)
            del got, want, again
        args0, kw = arg_sets[0]
        shapes0 = [getattr(a, 'shape', None) for a in args0]
        sets = [args for args, kwargs in arg_sets if same_configuration(kwargs, kw)
                and [getattr(a, 'shape', None) for a in args] == shapes0]
        errs = ' '.join(f'{k} {v:.2e}' for k, v in res['rel_err'].items())
        line = f'{label:6s} {key:28s} B={batch:5d} calls={len(arg_sets)} max rel err: {errs}'
        if batch == BATCH:
            res['ms'] = time_ms(torch, lambda *a: kernel_call(lbs_kernels, key, a, kw), sets)
            res['plain_ms'] = time_ms(torch, lambda *a: twin_call(lbs_kernels, key, a, kw), sets)
            lib = library_call(torch, key)
            res['library_ms'] = None if lib is None else time_ms(torch, lib, sets)
            res['bound_ms'], res['bound_by'] = bound(key, args0, kw)
            lib_txt = '' if lib is None else f'  library {res["library_ms"]:.3f} ms'
            line += (f'  kernel {res["ms"]:.3f} ms  twin {res["plain_ms"]:.3f} ms{lib_txt}'
                     f'  bound {res["bound_ms"]:.3f} ms ({res["bound_by"]})')
            if lib is not None:
                flops = kernel_work(key, args0, kw)[0]
                log(f'{label:6s} {key:28s} B={batch:5d} kernel {flops / res["ms"] / 1e9:.1f} '
                    f'TFLOP/s ({flops / res["ms"] * 1e3 / PEAK_F32_FLOPS:.3f} of the f32 peak), '
                    f'library {flops / res["library_ms"] / 1e9:.1f} TFLOP/s; kernel / library '
                    f'time {res["ms"] / res["library_ms"]:.3f}, repeats bit for bit')
        log(line)


def dense_weights(torch, w, V):
    """Skinning weights with every joint nonzero on every vertex below V
    (seeded, rows summing to 1), zero rows past V: the worst case of the
    active-joint blends."""
    g = torch.Generator(device=w.device).manual_seed(SEED)
    d = torch.rand(w.shape, generator=g, device=w.device) + 0.01
    d[V:] = 0.0
    return d / d.sum(dim=1, keepdim=True).clamp_min(1e-30)


def scale_mean(torch, tgt, om, mode):
    """The fitter's centring of K9's scale column: minus (scale_target) or
    plus (scale_fit) the ω-weighted target mean (3, B)."""
    t_mean = torch.einsum('avb,vb->ab', tgt, om) / om.sum(dim=0).clamp_min(1e-12)
    return (-t_mean if mode == 1 else t_mean).contiguous()


def widen(torch, t, E, axis):
    """A shape-column operand widened from E to 2E columns (its columns again,
    reversed and scaled by 0.7): K9's operands at E = 32. ``axis`` 0: rows
    (a, e) a-major, (3E, ...); 2: sd (3, V_pad, E)."""
    if axis == 2:
        return torch.cat([t, 0.7 * t.flip(2)], dim=2).contiguous()
    r = t.reshape((3, E) + tuple(t.shape[1:]))
    return torch.cat([r, 0.7 * r.flip(1)], dim=1).reshape((6 * E,) + tuple(t.shape[1:]))


def k6_forms(torch, calls):
    """K6's three forms on the paths' operands: the first captured call of
    each, and where a path captured none, the unweighted call with seeded
    weights (static (V_pad, 1), or per call (V, B))."""
    a0, _ = calls['recon_part_sums'][0]
    forms = {'': ('recon_part_sums', a0, {})}
    for a, k in calls['recon_part_sums_w']:
        form = ' static' if k['omega'].shape[1] == 1 else ' per-call'
        forms.setdefault(form, ('recon_part_sums_w', a, k))
    g = torch.Generator(device=a0[0].device).manual_seed(SEED)
    vp, (_, v_t, batch) = a0[3].shape[0], a0[0].shape
    for form, shape in ((' static', (vp, 1)), (' per-call', (v_t, batch))):
        om = 0.1 + 1.9 * torch.rand(shape, generator=g, device=a0[0].device)
        if form == ' static':
            om[v_t:] = 0.0
        forms.setdefault(form, ('recon_part_sums_w', a0, dict(omega=om)))
    return forms


def hold_blend_variants(torch, lbs_kernels, label, calls, batch, results, model) -> None:
    """The operand sets of this slice's redesigned kernels beyond the fitting
    paths' own calls, each held to its twin (and to a second call, bit for
    bit) and, at B=4096, timed (hold_to_twin): K9 in scale modes 1 and 2 (on
    the first captured call, centred as the fitter centres them) and K6's ω
    forms where no path captured them (k6_forms); on SMPL-X also dense
    skinning weights for K9 (modes 0-2) and K6 (its three forms), and K9 at
    E = 32 with the scale column, and K1 and K2 (cover_variants); and at
    B=4096 K6's yardstick: the same function from the port's own kernels, K7
    into a (3, V_pad, B) workspace and K4's cached form, held to K6's twin and
    timed beside K6, and K1 beside K7 on K1's own (feat, consts), a
    yardstick for its template dot."""
    dev = calls['wgram'][0][0][0].device
    sets = {}
    args9, kw9 = calls['wgram'][0]
    tgt, pj, homog, t4, w, sd, mu, om = args9
    for mode in (1, 2):
        sets[f'wgram mode {mode}'] = ('wgram', args9, dict(
            kw9, scale_mode=mode, mu_s=scale_mean(torch, tgt, om, mode)))
    forms = k6_forms(torch, calls)
    for form, (key, a, k) in forms.items():
        if form and not any(k is kk for _, kk in calls['recon_part_sums_w']):
            sets[f'recon_part_sums{form}'] = (key, a, k)
    if model == 'smplx':
        V = om.shape[0]
        wd = dense_weights(torch, w, V)
        cover = lbs_kernels.wgram_cover(wd.cpu().numpy(), V, dev)
        dense9 = (tgt, pj, homog, t4, wd, sd, mu, om)
        for mode in (0, 1, 2):
            kw = dict(kw9, scale_mode=mode, cover=cover,
                      mu_s=scale_mean(torch, tgt, om, mode) if mode else None)
            sets[f'wgram dense mode {mode}'] = ('wgram', dense9, kw)
        E = sd.shape[2]
        wide = (tgt, pj, homog, widen(torch, t4, E, 0), w, widen(torch, sd, E, 2),
                widen(torch, mu, E, 0), om)
        sets['wgram E=32 mode 2'] = ('wgram', wide, dict(kw9, scale_mode=2,
                                                         mu_s=scale_mean(torch, tgt, om, 2)))
        for form, (key, a, k) in forms.items():
            wd = dense_weights(torch, a[3], a[0].shape[1])
            parts = lbs_kernels.PartIndex.from_membership(a[5].pm.cpu().numpy(), dev,
                                                          weights=wd.cpu().numpy())
            sets[f'recon_part_sums dense{form}'] = (key, a[:3] + (wd, a[4], parts), k)
    sets.update(cover_variants(torch, lbs_kernels, calls, model))
    for name, (key, args, kw) in sets.items():
        hold_to_twin(torch, lbs_kernels, f'{label} {name}', key, [(args, kw)], batch,
                     results.setdefault(name, {}))
    if batch != BATCH:
        return
    # K6's yardstick: K7 then K4 on the same function's operands.
    k6_args = forms[''][1]
    tgt, pj, feat, w, consts, parts = k6_args
    P1 = 9 * (pj.shape[1] - 1) + 1
    feat_p, x = feat[:P1].contiguous(), feat[P1:].contiguous()
    consts_p, sd = consts[:, :, :P1].contiguous(), consts[:3, :, P1:].contiguous()

    def composed():
        homog = lbs_kernels.posed_template_lm(feat_p, consts_p)
        return lbs_kernels.recon_part_sums_cached_lm(tgt, pj, x, sd, homog, parts, w)

    with torch.no_grad():
        got, want = composed(), twin_call(lbs_kernels, 'recon_part_sums', k6_args, {})
        torch.cuda.synchronize()
        for g, t in zip(got, want, strict=True):
            rel = (g - t).abs().max().item() / t.abs().max().item()
            if rel > KERNEL_REL_TOL:
                raise AssertionError(f'{label} K7 + K4 yardstick: {rel:.3e} x max|twin| from '
                                     "K6's twin")
        ms = time_ms(torch, composed, [()] * 5)
        k6_ms = time_ms(torch, lambda: kernel_call(lbs_kernels, 'recon_part_sums', k6_args, {}),
                        [()] * 5)
    results['yardstick'] = dict(ms=ms, k6_ms=k6_ms)
    log(f'{label:6s} recon_part_sums (K6) {k6_ms:.3f} ms against K7 + K4 (posed template, then '
        f'the cached part sums) {ms:.3f} ms on the same operands, B={batch}')
    # K1's yardstick for its template dot: K7 on K1's own (feat, consts).
    k1_args, k1_kw = max(calls['lbs_points'], key=lambda c: c[0][1].shape[0])  # the widest F
    feat, consts = k1_args[1], k1_args[3]
    with torch.no_grad():
        k1_ms = time_ms(torch, lambda: kernel_call(lbs_kernels, 'lbs_points', k1_args, k1_kw),
                        [()] * 5)
        k7_ms = time_ms(torch, lambda: lbs_kernels.posed_template_lm(feat, consts), [()] * 5)
    results['k1_yardstick'] = dict(ms=k1_ms, k7_ms=k7_ms)
    log(f'{label:6s} lbs_points (K1) {k1_ms:.3f} ms against K7 (the template dot alone) '
        f'{k7_ms:.3f} ms on its (feat, consts), F={feat.shape[0]}, B={batch}')


def cover_variants(torch, lbs_kernels, calls, model) -> dict:
    """K1 and K2 beyond the fitting paths' own calls: on SMPL-X K1 and K2's
    cached forms (plain and scale) with dense skinning weights and their
    cover, and K2's cached forms at E = 32 (the shape directions widened);
    on SMPL K2's emit form with dense weights. name -> (key, args, kwargs)."""
    sets = {}
    dev = calls['lbs_points'][0][0][0].device

    def dense(args, kw, w_at):
        V = kw['cover'].covers
        wd = dense_weights(torch, args[w_at], V)
        cover = lbs_kernels.wgram_cover(wd.cpu().numpy(), V, dev)
        return args[:w_at] + (wd,) + args[w_at + 1:], dict(kw, cover=cover)

    if model == 'smplx':
        a, k = max(calls['lbs_points'], key=lambda c: c[0][1].shape[0])  # widest F: 504
        sets['lbs_points dense'] = ('lbs_points',) + dense(a, k, 2)
        for key in ('rhs_moments_cached', 'rhs_moments_cached_scale'):
            a, k = next((a, k) for a, k in calls[key] if a[4].shape[2] == 16)
            sets[f'{key} dense'] = (key,) + dense(a, k, 3)
            sets[f'{key} E=32'] = (key, a[:4] + (widen(torch, a[4], 16, 2),), k)
    else:
        a, k = calls['rhs_moments_h'][0]
        sets['rhs_moments_h dense'] = ('rhs_moments_h',) + dense(a, k, 3)
    return sets


# The torch-op backward passes, each timed in phase 3 at B=4096 on a captured
# call of its forward form: TORCH_VJPS key -> (forward LAUNCHES key, True for
# per-call ω only, the differentiated arguments' positions and keywords, as a
# fit's gradient differentiates them).
TORCH_VJP_FORMS = {
    'rhs_moments_scale': ('rhs_moments_scale', False, (0, 1, 2), ()),
    'rhs_moments_scale_w': ('rhs_moments_scale_w', False, (0, 1, 2), ()),
    'rhs_moments_cached_scale': ('rhs_moments_cached_scale', False, (0, 1, 2), ()),
    'rhs_moments_cached_scale_w': ('rhs_moments_cached_scale_w', False, (0, 1, 2), ()),
    'recon_part_sums_cached_call_w': ('recon_part_sums_cached_w', True, (0, 1, 2, 4),
                                      ('omega',)),
    'part_sums_call_w': ('part_sums_w', True, (0, 1), ('omega',)),
    'recon_part_sums_call_w': ('recon_part_sums_w', True, (0, 1, 2), ('omega',)),
    'wgram': ('wgram', False, (0, 1, 2, 3, 6), ('omega_vm', 'mu_s')),
}


def time_torch_vjp(torch, lbs_kernels, label, key, calls, results) -> None:
    """Median device time of one torch-op backward pass (after a warm-up,
    over 3 runs, each on a fresh forward call) on the first captured call of
    its form; the forward kernel is outside the timed window."""
    fwd, call_omega, pos, kws = TORCH_VJP_FORMS[key]
    picks = [(a, k) for a, k in calls.get(fwd, []) if not call_omega or k['omega'].shape[1] > 1]
    if not picks:
        return
    args, kwargs = picks[0]
    kwargs = dict(kwargs)
    if fwd == 'wgram':  # ω is wgram_moments' 8th positional argument
        args, kwargs = args[:7], dict(kwargs, omega_vm=args[7])
    times = []
    for rep in range(4):
        a = [x.detach().requires_grad_() if i in pos else x for i, x in enumerate(args)]
        k = {n: v.detach().requires_grad_() if n in kws and v is not None else v
             for n, v in kwargs.items()}
        leaves = [a[i] for i in pos] + [k[n] for n in kws if k.get(n) is not None]
        outs = getattr(lbs_kernels, SPECS[fwd][0])(*a, **k)
        before = lbs_kernels.TORCH_VJPS[key]
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.autograd.grad(outs, leaves, [torch.ones_like(o) for o in outs])
        end.record()
        end.synchronize()
        if lbs_kernels.TORCH_VJPS[key] != before + 1:
            raise AssertionError(f'{label} {key}: the backward did not run in torch ops')
        if rep:
            times.append(start.elapsed_time(end))
    results[key] = statistics.median(times)
    log(f'{label:6s} torch-op backward {key:30s} B={args[0].shape[2]:5d} '
        f'{results[key]:.3f} ms (forward kernel {fwd})')


def bwd_key(wrapper: str, kwargs) -> str:
    """The LAUNCHES key of a backward wrapper's call."""
    key = {'lbs_points_bwd': 'lbs_points_bwd',
           'rhs_moments_bwd': ('rhs_moments_h_bwd' if kwargs.get('gh') is not None
                               else 'rhs_moments_bwd'),
           'rhs_moments_cached_bwd': 'rhs_moments_cached_bwd',
           'recon_part_sums_cached_bwd': 'recon_part_sums_cached_bwd',
           'recon_part_sums_bwd': 'recon_part_sums_bwd',
           'part_sums_bwd': 'part_sums_bwd'}[wrapper]
    return key + ('_w' if kwargs.get('omega') is not None else '')


def known_pose_loss(res):
    """The loss of the known-pose gradient: summed squares of betas and
    translation."""
    return (res['shape_betas'] ** 2).sum() + (res['trans'] ** 2).sum()


def known_pose_vg(torch, fitter, pose):
    """``vg(tv, tj) -> (value, (g_tv,))``: known_pose_loss of the known-pose
    fit and its gradient in the target vertices (tj unused)."""
    def vg(tv, tj):
        tv = tv.detach().requires_grad_()
        loss = known_pose_loss(fitter.fit_with_known_pose(pose.to(tv.device), tv))
        return loss.detach(), torch.autograd.grad(loss, tv)
    return vg


def backward_pass(torch, bm, fitters, params, path_fitters=None) -> None:
    """The gradients of a forward pass (sum of sin(vertices) in pose, betas and
    translation), of each fitter's headline fit (the default loss in the
    targets) and of its known-pose fit (known_pose_loss in the vertices); with
    ``path_fitters`` (GRAD_PATHS' fitter keys -> fitters) also of each
    CAPTURE_PATHS path whose fitter is given, warm-started from the params
    and kid factors in [-0.5, 0.5]."""
    from smplfitter_tpu_torch.api import default_loss

    p = [x.detach().requires_grad_() for x in params]
    out = bm(*p)
    torch.autograd.grad(torch.sin(out['vertices']).sum(), p)
    tv = out['vertices'].detach().requires_grad_()
    tj = out['joints'].detach().requires_grad_()
    for fitter in fitters:
        torch.autograd.grad(default_loss(fitter.fit(tv, tj, **FIT_KW)), (tv, tj))
        torch.autograd.grad(known_pose_loss(fitter.fit_with_known_pose(params[0], tv)), tv)
    if path_fitters is None:
        return
    batch = tv.shape[0]
    inputs = tuple(params) + (torch.linspace(-0.5, 0.5, batch, device=tv.device), None, None)
    for name in CAPTURE_PATHS:
        if GRAD_PATHS[name]['fitter'] in path_fitters:
            path_vg(torch, name, path_fitters, inputs)(tv, tj)


def summed_calls(torch, calls) -> list:
    """K15's summed form on the operands of captured batched calls: the
    reference's first column as the batch-constant reference, and s_a's
    cotangent summed over the batch."""
    out = []
    for args, kwargs in calls:
        graw, gst, gsa, t, a, parts = args
        out.append(((graw, gst, gsa.sum(dim=2, keepdim=True), t, a[:, :, :1].contiguous(),
                     parts), kwargs))
    return out


def check_backward_kernels(torch, lbs_kernels, label, bm, fitters, path_fitters, dev, rng,
                           model) -> dict:
    """Phase 13 for one model: capture the backward kernels' operands from the
    backward passes at B=4096 and B=1000, assert which kernels they reach,
    hold each (and K15's summed form) to its twin and at B=4096 time it."""
    results = {}
    for batch in (BATCH, RAGGED_BATCH):
        params = [torch.as_tensor(x, device=dev) for x in random_params(rng, batch, model)]
        calls = record_calls(lbs_kernels, BWD_WRAPPERS,
                             lambda: backward_pass(torch, bm, fitters, params, path_fitters),
                             bwd_key)
        captured = {key for key, arg_sets in calls.items() if arg_sets}
        if captured != BWD_CAPTURED[model]:
            raise AssertionError(f'{label} at B={batch}: the gradients reached {sorted(captured)},'
                                 f' expected {sorted(BWD_CAPTURED[model])}')
        for key in list(SUMMED):
            batched = key.replace('bwd_sum', 'bwd')
            if batched in captured:
                calls[key] = summed_calls(torch, calls[batched])
                captured.add(key)
        for key in [k for k in SPECS if k in captured]:
            hold_to_twin(torch, lbs_kernels, label, key, calls[key], batch, results)
        if model == 'smplx':
            variants = results.setdefault('variants', {})
            for name, (key, args, kw) in dense_bwd_variants(torch, lbs_kernels, calls).items():
                hold_to_twin(torch, lbs_kernels, f'{label} {name}', key, [(args, kw)], batch,
                             variants.setdefault(name, {}))
        del calls
        torch.cuda.empty_cache()
    return results


def dense_bwd_variants(torch, lbs_kernels, calls) -> dict:
    """K10 and K14 (unweighted and ω) on the first captured call of each,
    with dense skinning weights (every joint on every vertex: the longest
    lists) and the lists of those weights: a cover for K10, a part index
    for K14. name -> (key, args, kwargs)."""
    sets = {}
    args, kw = calls['lbs_points_bwd'][0]
    dev = args[0].device
    V = kw['cover'].covers
    wd = dense_weights(torch, args[3], V)
    sets['lbs_points_bwd dense'] = ('lbs_points_bwd', args[:3] + (wd, args[4]), dict(
        kw, cover=lbs_kernels.wgram_cover(wd.cpu().numpy(), V, dev)))
    for key in ('recon_part_sums_bwd', 'recon_part_sums_bwd_w'):
        args, kw = calls[key][0]
        wd = dense_weights(torch, args[6], args[3].shape[1])
        parts = lbs_kernels.PartIndex.from_membership(args[8].pm.cpu().numpy(), dev,
                                                      weights=wd.cpu().numpy())
        sets[f'{key} dense'] = (key, args[:6] + (wd, args[7], parts), kw)
    return sets


def grad_parity(name, vg_card, vg_cpu, tv, tj, failures, noise_floor=False) -> None:
    """A value-and-gradient function on the card and on the CPU: each
    gradient within GRAD_PARITY_REL x max|g_cpu|, with ``noise_floor`` within
    the larger of that and SPREAD_MULT x the gradient's own spread (its largest
    change, relative to max|g|, over NOISE_SEEDS seeded changes of tv and tj
    by a factor 1 + NOISE_REL N(0, 1), on the CPU and on the card)."""
    import torch

    tv_c, tj_c = tv.cpu(), tj.cpu()
    card = vg_card(tv, tj)[1]
    cpu = vg_cpu(tv_c, tj_c)[1]

    def rel(a, b):
        return max(((x.cpu() - y.cpu()).abs().max() / y.abs().max().cpu()).item()
                   for x, y in zip(a, b))

    err = rel(card, cpu)
    limit, spread = GRAD_PARITY_REL, ''
    if noise_floor:
        own = dict(cpu=0.0, card=0.0)
        for seed in range(NOISE_SEEDS):
            g = torch.Generator().manual_seed(SEED + seed)
            tv_n, tj_n = (t * (1 + NOISE_REL * torch.randn(t.shape, generator=g))
                          for t in (tv_c, tj_c))
            own['cpu'] = max(own['cpu'], rel(vg_cpu(tv_n, tj_n)[1], cpu))
            own['card'] = max(own['card'], rel(vg_card(tv_n.to(tv.device),
                                                       tj_n.to(tv.device))[1], card))
        limit = max(limit, SPREAD_MULT * max(own.values()))
        spread = (f'; own spread over {NOISE_SEEDS} target changes x (1 + {NOISE_REL:g} N): '
                  f'cpu {own["cpu"]:.3e} card {own["card"]:.3e}, limit {SPREAD_MULT}x')
    ok = err <= limit and all(torch.isfinite(g).all().item() for g in card)
    log(f'{name}: ok={ok} max|g_card - g_cpu| / max|g_cpu| = {err:.3e} (limit {limit:.3e}; '
        f'{GRAD_PARITY_REL:g} {"held" if err <= GRAD_PARITY_REL else "missed"}){spread}')
    if not ok:
        failures.append(name)


def time_path(torch, lbs_kernels, run, fitter, fitter_kid, targets, inputs, kids):
    """Warm-up, then the path on every target set between CUDA events: (fits,
    launches, device ms over all sets, host s over all sets)."""
    lbs_kernels.reset_launch_counts()
    run(fitter, fitter_kid, *targets[0], inputs[0] + (kids[0],))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    fits = [run(fitter, fitter_kid, tv, tj, p + (k,))
            for (tv, tj), p, k in zip(targets, inputs, kids)]
    end.record()
    torch.cuda.synchronize()
    check_host_covers(lbs_kernels, 'a fitting path')
    return fits, dict(lbs_kernels.LAUNCHES), start.elapsed_time(end), time.perf_counter() - t0


def max_dparams(a, b) -> float:
    return max((a[k].cpu() - b[k].cpu()).abs().max().item()
               for k in ('shape_betas', 'kid_factor', 'scale_corr') if k in a)


def parity(name, run, gpu_fitters, cpu_fitters, bm, tv, tj, params, failures,
           noise_floor=False) -> None:
    """One path on the card and on the CPU: max|d betas, kid, scale| within
    PARITY_DBETA and mean reconstruction errors within 0.01 mm; a miss is
    appended to ``failures``. With ``noise_floor`` the betas' limit is the
    larger of PARITY_DBETA and SPREAD_MULT x the fit's own spread: the largest
    change of its parameters, on the CPU and on the card, over NOISE_SEEDS
    seeded changes of tv and tj by a factor 1 + NOISE_REL N(0, 1)."""
    import torch

    gpu = run(*gpu_fitters, tv, tj, params)
    cpu_args = (tv.cpu(), tj.cpu(), tuple(x.cpu() for x in params))
    cpu = run(*cpu_fitters, *cpu_args)
    max_d = max_dparams(gpu, cpu)
    limit, spread = PARITY_DBETA, ''
    if noise_floor:
        own = dict(cpu=0.0, card=0.0)
        for seed in range(NOISE_SEEDS):
            g = torch.Generator().manual_seed(SEED + seed)
            tv_n, tj_n = (t * (1 + NOISE_REL * torch.randn(t.shape, generator=g))
                          for t in cpu_args[:2])
            own['cpu'] = max(own['cpu'], max_dparams(run(*cpu_fitters, tv_n, tj_n,
                                                         cpu_args[2]), cpu))
            own['card'] = max(own['card'], max_dparams(
                run(*gpu_fitters, tv_n.to(tv.device), tj_n.to(tv.device), params), gpu))
        limit = max(limit, SPREAD_MULT * max(own.values()))
        spread = (f'; own spread over {NOISE_SEEDS} target changes x (1 + {NOISE_REL:g} N): '
                  f'cpu {own["cpu"]:.3e} card {own["card"]:.3e}, limit {SPREAD_MULT}x')
    v2v_gpu, v2v_cpu = recon_v2v_mm(bm, gpu, tv), recon_v2v_mm(bm, cpu, tv)
    ok = max_d <= limit and abs(v2v_gpu - v2v_cpu) <= PARITY_V2V_MM
    line = (f'{name}: ok={ok} max|d betas, kid, scale|={max_d:.3e} (limit {limit:.3e}; '
            f'{PARITY_DBETA:g} {"held" if max_d <= PARITY_DBETA else "missed"}) '
            f'v2v card={v2v_gpu:.4f} mm cpu={v2v_cpu:.4f} mm{spread}')
    log(line)
    if not ok:
        failures.append(name)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1

    import smplfitter_tpu_torch as port
    from smplfitter_tpu_torch.ops import _build, lbs_kernels
    from smplfitter_tpu_torch.utils import synthetic

    # The fit's precision rule: f32 products without TF32 (the port's default).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    rng = np.random.default_rng(SEED)
    kid_rng = np.random.default_rng(SEED + 1)

    # 1. Toolchain.
    log('== phase 1: toolchain')
    log(f'python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}')
    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f'device: {card}  count {torch.cuda.device_count()}  nvidia-smi: {smi}')
    nvcc = subprocess.run([_build.nvcc_path(), '--version'], capture_output=True, text=True,
                          check=True, timeout=60)
    log('nvcc: ' + nvcc.stdout.strip().splitlines()[-1])

    # 2. Build.
    log('== phase 2: build')
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f'built {lib_path.relative_to(_build.PACKAGE_DIR.parent)} in '
        f'{time.perf_counter() - t0:.1f} s')
    for line in (lib_path.parent / 'build.log').read_text().splitlines():
        if any(key in line for key in ('Compiling entry', 'Used', 'spill stores')):
            log('  ' + line.strip())

    # The synthetic models live beside the build, inside the checkout.
    models_dir = synthetic.ensure_cached_models(
        os.path.join(_build.BUILD_ROOT, 'synthetic_models'))

    def load(name, kid=False):
        bm = port.BodyModel(name, 'neutral', model_root=os.path.join(models_dir, name),
                            device=dev)
        return bm, port.BodyFitter(bm), port.BodyFitter(bm, enable_kid=True) if kid else None

    # 3. Kernels against their twins on the fitting paths' operands.
    log('== phase 3: kernels vs plain twins (synthetic SMPL V=6890; SMPL-X V=10475)')
    bm, fitter, fitter_kid = load('smpl', kid=True)
    bm_x, fitter_x, fitter_x_kid = load('smplx', kid=True)
    w_rng = np.random.default_rng(SEED + 2)
    wfitters = {'smpl': weighted_fitters(port, bm, 'smpl', w_rng, fitter),
                'smplx': weighted_fitters(port, bm_x, 'smplx', w_rng, fitter_x)}

    def with_weights(bm, p):
        """An input tuple with seeded per-call vertex and joint weights appended."""
        batch = p[0].shape[0]
        return p + (fit_weights(torch, w_rng, batch, bm.num_vertices, dev),
                    fit_weights(torch, w_rng, batch, bm.num_joints, dev))

    def make_run(bm, fitter, fitter_kid, fs, extra=()):
        def run_for(params, kid):
            def run():
                for p in params:
                    out = bm(*p)
                tv, tj = out['vertices'], out['joints']
                fitter.fit(tv, tj, **FIT_KW)
                p = tuple(torch.as_tensor(x, device=dev) for x in params[-1]) + (kid,)
                for path in list(PATHS.values()) + list(extra):
                    path['run'](fitter, fitter_kid, tv, tj, p)
                p = with_weights(bm, p)
                for name, path in WPATHS.items():
                    if name != 'i_hand_replacer':  # SMPL+H only; its kernels are covered
                        path['run'](fs, tv, tj, p)
            return run
        return run_for

    results = {'smpl': check_kernels(torch, lbs_kernels, 'smpl',
                                     make_run(bm, fitter, fitter_kid, wfitters['smpl']),
                                     dev, rng, kid_rng, 'smpl')}
    results['smplx'] = check_kernels(
        torch, lbs_kernels, 'smplx',
        make_run(bm_x, fitter_x, fitter_x_kid, wfitters['smplx'], [KID_JOINTS]), dev, rng,
        kid_rng, 'smplx')
    torch.cuda.empty_cache()

    # 4./5. The main path: forward to make targets, then fit them.
    log(f'== phase 4: forward, {N_TARGETS} target sets at B={BATCH}')
    inputs = [
        tuple(torch.as_tensor(x, device=dev) for x in random_params(rng, BATCH))
        for _ in range(N_TARGETS)
    ]
    lbs_kernels.reset_launch_counts()
    t0 = time.perf_counter()
    targets = []
    for p in inputs:
        out = bm(*p)
        targets.append((out['vertices'], out['joints']))
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    fwd_launches = lbs_kernels.LAUNCHES['lbs_points']
    check_host_covers(lbs_kernels, 'phase 4')
    if fwd_launches < 1:
        raise AssertionError('the forward pass did not launch lbs_points')
    log(f'forward: {N_TARGETS} x B={BATCH} in {fwd_s * 1e3:.1f} ms, lbs_points launches '
        f'{fwd_launches}')
    total_launches = dict(lbs_kernels.LAUNCHES)

    log(f'== phase 5: fit, B={BATCH}, {N_TARGETS} distinct target sets')
    kids = [torch.as_tensor(kid_factors(kid_rng, BATCH), device=dev) for _ in range(N_TARGETS)]
    fits, launches, fit_ms, host_s = time_path(torch, lbs_kernels, HEADLINE['run'], fitter,
                                               fitter_kid, targets, inputs, kids)
    n_fits = N_TARGETS + 1
    check_launches(launches, HEADLINE['launches'], n_fits, 'phase 5')
    shapes = dict(pose_rotvecs=(BATCH, 72), shape_betas=(BATCH, 10), trans=(BATCH, 3))
    for res in fits:
        for key, shape in shapes.items():
            if tuple(res[key].shape) != shape or not torch.isfinite(res[key]).all():
                raise AssertionError(f'fit output {key}: shape {tuple(res[key].shape)}, '
                                     f'expected {shape}, or not finite')
    log(f'launches in the main path: {json.dumps(launches)}')
    log(f'fit throughput: {N_TARGETS * BATCH / (fit_ms / 1e3):.1f} fits/s (B={BATCH}, '
        f'{N_TARGETS} fits, {fit_ms / N_TARGETS:.2f} ms/fit on CUDA events, '
        f'{host_s / N_TARGETS * 1e3:.2f} ms/fit host) on {smi}')
    refit = bm(fits[-1]['pose_rotvecs'], fits[-1]['shape_betas'], fits[-1]['trans'])
    v2v_mm = (refit['vertices'] - targets[-1][0]).norm(dim=-1).mean().item() * 1e3
    if not np.isfinite(v2v_mm):
        raise AssertionError('round-trip reconstruction is not finite')
    log(f'round-trip mean v2v: {v2v_mm:.4f} mm')
    for key in total_launches:
        total_launches[key] += launches[key]
    del fits, refit
    torch.cuda.empty_cache()

    # 6. Card against the CPU twins at B=32.
    log(f'== phase 6: parity, B={PARITY_BATCH}, card vs CPU')
    cpu_models = {}

    def cpu_fitters(name, bm, kid=False):
        if name not in cpu_models:
            cpu_bm = port.BodyModel.from_model_data(bm.model_data, name, device='cpu')
            cpu_models[name] = (port.BodyFitter(cpu_bm),
                                port.BodyFitter(cpu_bm, enable_kid=True) if kid else None)
        return cpu_models[name]

    params = tuple(torch.as_tensor(x, device=dev) for x in random_params(rng, PARITY_BATCH))
    params += (torch.as_tensor(kid_factors(kid_rng, PARITY_BATCH), device=dev),)
    out = bm(*params)
    tv, tj = out['vertices'].contiguous(), out['joints'].contiguous()
    failures = []
    parity('headline', HEADLINE['run'], (fitter, fitter_kid), cpu_fitters('smpl', bm, True), bm,
           tv, tj, params, failures)

    # 7. The other fitting paths on the same target sets.
    for name, path in PATHS.items():
        log(f'== phase 7{name[0]}: {name}, B={BATCH}, {N_TARGETS} distinct target sets')
        fits, launches, path_ms, host_s = time_path(torch, lbs_kernels, path['run'], fitter,
                                                    fitter_kid, targets, inputs, kids)
        check_launches(launches, path['launches'], n_fits, name)
        for key in total_launches:
            total_launches[key] += launches[key]
        for res in fits:
            for key, value in res.items():
                if value.shape[0] != BATCH or not torch.isfinite(value).all():
                    raise AssertionError(f'{name} output {key}: shape {tuple(value.shape)} '
                                         'or not finite')
        log(f'{name}: {N_TARGETS * BATCH / (path_ms / 1e3):.1f} fits/s '
            f'({path_ms / N_TARGETS:.2f} ms/fit on CUDA events, '
            f'{host_s / N_TARGETS * 1e3:.2f} ms/fit host), launches per fit '
            f'{json.dumps(path["launches"])} on {smi}')
        del fits
    del targets, inputs, kids
    torch.cuda.empty_cache()

    # 8. Each other path on the card against the CPU twins at B=32.
    log(f'== phase 8: parity of paths a-e, B={PARITY_BATCH}, card vs CPU')
    for name, path in PATHS.items():
        parity(name, path['run'], (fitter, fitter_kid), cpu_fitters('smpl', bm, True), bm, tv, tj,
               params, failures)

    # 9. SMPL-X at full width: forward, then the headline fit and paths a-e.
    log(f'== phase 9: SMPL-X (V=10475, J=55, F=487), forward and fits, B={BATCH}, '
        f'{N_TARGETS} distinct target sets')
    inputs = [tuple(torch.as_tensor(x, device=dev) for x in random_params(rng, BATCH, 'smplx'))
              for _ in range(N_TARGETS)]
    kids = [torch.as_tensor(kid_factors(kid_rng, BATCH), device=dev) for _ in range(N_TARGETS)]
    lbs_kernels.reset_launch_counts()
    bm_x(*inputs[0])  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    targets = []
    for p in inputs:
        out = bm_x(*p)
        targets.append((out['vertices'], out['joints']))
    end.record()
    torch.cuda.synchronize()
    check_launches(dict(lbs_kernels.LAUNCHES), dict(lbs_points=1), n_fits, 'smplx forward')
    check_host_covers(lbs_kernels, 'smplx forward')
    total_launches['lbs_points'] += lbs_kernels.LAUNCHES['lbs_points']
    log(f'smplx forward: {start.elapsed_time(end) / N_TARGETS:.3f} ms per B={BATCH} call '
        f'(CUDA events), lbs_points launches {lbs_kernels.LAUNCHES["lbs_points"]} on {smi}')
    for name, path in dict(headline=HEADLINE, **PATHS).items():
        fits, launches, path_ms, host_s = time_path(torch, lbs_kernels, path['run'], fitter_x,
                                                    fitter_x_kid, targets, inputs, kids)
        check_launches(launches, path['launches_x'], n_fits, f'smplx {name}')
        for key in total_launches:
            total_launches[key] += launches[key]
        for res in fits:
            for key, value in res.items():
                if value.shape[0] != BATCH or not torch.isfinite(value).all():
                    raise AssertionError(f'smplx {name} output {key}: shape '
                                         f'{tuple(value.shape)} or not finite')
        log(f'smplx {name}: {N_TARGETS * BATCH / (path_ms / 1e3):.1f} fits/s '
            f'({path_ms / N_TARGETS:.2f} ms/fit on CUDA events, '
            f'{host_s / N_TARGETS * 1e3:.2f} ms/fit host), launches per fit '
            f'{json.dumps(path["launches_x"])} on {smi}')
        del fits
    del targets, inputs, kids
    torch.cuda.empty_cache()

    # 10. The large models on the card against the CPU twins at B=32.
    log(f'== phase 10: parity of SMPL-X (headline, a-e), SMPL+H and MANO, B={PARITY_BATCH}, '
        'card vs CPU')
    params = tuple(torch.as_tensor(x, device=dev)
                   for x in random_params(rng, PARITY_BATCH, 'smplx'))
    params += (torch.as_tensor(kid_factors(kid_rng, PARITY_BATCH), device=dev),)
    out = bm_x(*params)
    tv, tj = out['vertices'].contiguous(), out['joints'].contiguous()
    for name, path in dict(headline=HEADLINE, **PATHS).items():
        parity(f'smplx {name}', path['run'], (fitter_x, fitter_x_kid),
               cpu_fitters('smplx', bm_x, True), bm_x, tv, tj, params, failures,
               noise_floor=True)
    for name in ('smplh16', 'mano'):
        bm_o, fitter_o, _ = load(name)
        params = tuple(torch.as_tensor(x, device=dev)
                       for x in random_params(rng, PARITY_BATCH, name))
        out = bm_o(*params)
        tv, tj = out['vertices'].contiguous(), out['joints'].contiguous()
        parity(f'{name} headline', HEADLINE['run'], (fitter_o, None),
               cpu_fitters(name, bm_o), bm_o, tv, tj, params, failures, noise_floor=True)

    # 11. The fit-weight paths at full width.
    bm_h, fitter_h, _ = load('smplh16')
    wfitters['smplh16'] = weighted_fitters(port, bm_h, 'smplh16', w_rng, fitter_h)
    wmodels = {'smpl': bm, 'smplx': bm_x, 'smplh16': bm_h}
    log(f'== phase 11: fit-weight paths f-l, B={BATCH}, {N_TARGETS} distinct target sets')
    for model, bm_w in wmodels.items():
        paths = {name: path for name, path in WPATHS.items() if model in path['models']}
        inputs = [with_weights(bm_w, tuple(torch.as_tensor(x, device=dev)
                                           for x in random_params(rng, BATCH, model))
                               + (torch.as_tensor(kid_factors(kid_rng, BATCH), device=dev),))
                  for _ in range(N_TARGETS)]
        targets = []
        for p in inputs:
            out = bm_w(*p[:3])
            targets.append((out['vertices'], out['joints']))
        for name, path in paths.items():
            def run(fs, _unused, tv, tj, p, path=path):
                return path['run'](fs, tv, tj, p)
            fits, launches, path_ms, host_s = time_path(
                torch, lbs_kernels, run, wfitters[model], None, targets, inputs,
                [None] * N_TARGETS)
            per_fit = wpath_launches(path, model)
            check_launches(launches, per_fit, n_fits, f'{model} {name}')
            for key in total_launches:
                total_launches[key] += launches[key]
            for res in fits:
                for key, value in res.items():
                    if value.shape[0] != BATCH or not torch.isfinite(value).all():
                        raise AssertionError(f'{model} {name} output {key}: shape '
                                             f'{tuple(value.shape)} or not finite')
            log(f'{model} {name}: {N_TARGETS * BATCH / (path_ms / 1e3):.1f} fits/s '
                f'({path_ms / N_TARGETS:.2f} ms/fit on CUDA events, '
                f'{host_s / N_TARGETS * 1e3:.2f} ms/fit host), launches per fit '
                f'{json.dumps(per_fit)} on {smi}')
            del fits
        del inputs, targets
        torch.cuda.empty_cache()

    # 12. The fit-weight paths on the card against the CPU twins at B=32.
    log(f'== phase 12: parity of paths f-l, B={PARITY_BATCH}, card vs CPU')
    for model, bm_w in wmodels.items():
        fs = wfitters[model]
        cpu_bm = port.BodyModel.from_model_data(bm_w.model_data, model, device='cpu')
        cpu_fs = cpu_path_fitters(port, cpu_bm, fs)
        params = tuple(torch.as_tensor(x, device=dev)
                       for x in random_params(rng, PARITY_BATCH, model))
        params = with_weights(bm_w, params + (torch.as_tensor(
            kid_factors(kid_rng, PARITY_BATCH), device=dev),))
        out = bm_w(*params[:3])
        tv, tj = out['vertices'].contiguous(), out['joints'].contiguous()
        for name, path in WPATHS.items():
            if model in path['models']:
                parity(f'{model} {name}', path['run'], (fs,), (cpu_fs,), bm_w, tv, tj, params,
                       failures, noise_floor=model != 'smpl')
    # 13. The backward kernels against their twins on real backward passes.
    log('== phase 13: backward kernels vs plain twins (SMPL, SMPL-X, MANO V=778; forward '
        'pass, headline and known-pose fits, static weights on SMPL and SMPL-X, and the '
        'gradient paths ' + ', '.join(CAPTURE_PATHS) + ')')
    bm_m, fitter_m, _ = load('mano')
    path_fitters = {'smpl': dict(wfitters['smpl'], kid=fitter_kid),
                    'smplx': dict(wfitters['smplx'], kid=fitter_x_kid)}
    bwd_results = {
        'smpl': check_backward_kernels(torch, lbs_kernels, 'smpl', bm,
                                       (fitter, wfitters['smpl']['static']),
                                       path_fitters['smpl'], dev, rng, 'smpl'),
        'smplx': check_backward_kernels(torch, lbs_kernels, 'smplx', bm_x,
                                        (fitter_x, wfitters['smplx']['static']),
                                        path_fitters['smplx'], dev, rng, 'smplx'),
        'mano': check_backward_kernels(torch, lbs_kernels, 'mano', bm_m, (fitter_m,),
                                       dict(plain=fitter_m), dev, rng, 'mano')}
    torch.cuda.empty_cache()

    # 14. This slice's paths: value and gradient at full width, launches asserted.
    log(f'== phase 14: value and gradient, B={BATCH}, {N_GRAD_TARGETS} distinct target sets')

    def headline(f):
        vg = port.get_fit_grad_fn(f)
        return (lambda tv, tj, p: f.fit(tv, tj, **FIT_KW),
                lambda tv, tj, p: vg(tv, tj))

    def known_pose(f):
        return (lambda tv, tj, p: f.fit_with_known_pose(p[0], tv),
                lambda tv, tj, p: known_pose_vg(torch, f, p[0])(tv, tj))

    def grad_path(name, fs):
        run = GRAD_PATHS[name]['run']
        return (lambda tv, tj, p: run(fs, tv, tj, p),
                lambda tv, tj, p: path_vg(torch, name, fs, p)(tv, tj))

    static, static_x = wfitters['smpl']['static'], wfitters['smplx']['static']
    # name -> (model, (fit call, value-and-gradient call), launches and
    # TORCH_VJPS counts per value+grad)
    grad_paths = {
        'smpl headline': (bm, headline(fitter), (dict(
            rhs_moments_h=3, gram_assembly=3, recon_part_sums_cached=3, rhs_moments_h_bwd=3,
            recon_part_sums_cached_bwd=3), dict(gram_assembly=3))),
        'smpl h_static_weights': (bm, headline(static), (dict(
            rhs_moments_h_w=3, gram_assembly=3, recon_part_sums_cached_w=3,
            rhs_moments_h_bwd_w=3, recon_part_sums_cached_bwd_w=3), dict(gram_assembly=3))),
        'smpl d_known_pose': (bm, known_pose(fitter), (dict(
            rhs_moments=1, gram_assembly=1, rhs_moments_bwd=1), dict(gram_assembly=1))),
        'smpl d_known_pose static weights': (bm, known_pose(static), (dict(
            rhs_moments_w=1, gram_assembly=1, rhs_moments_bwd_w=1), dict(gram_assembly=1))),
        'smplx headline': (bm_x, headline(fitter_x), (dict(
            _per_solve(3, recon_part_sums_cached=3), rhs_moments_cached_bwd=3,
            recon_part_sums_cached_bwd=3), dict(posed_template=3, term1=3))),
        'smplx h_static_weights': (bm_x, headline(static_x), (dict(
            posed_template=3, rhs_moments_cached_w=3, term1=3, recon_part_sums_cached_w=3,
            rhs_moments_cached_bwd_w=3, recon_part_sums_cached_bwd_w=3),
            dict(posed_template=3, term1=3))),
    }
    for model, bm_g in (('smpl', bm), ('smplx', bm_x)):
        for name in GRAD_PATHS:
            grad_paths[f'{model} {name}'] = (bm_g, grad_path(name, path_fitters[model]),
                                             grad_path_counts(name, model))
    for name, (bm_g, (fit_fn, vg), (per_grad, vjps)) in grad_paths.items():
        model = name.split()[0]
        targets = []
        for _ in range(N_GRAD_TARGETS):
            p = tuple(torch.as_tensor(x, device=dev) for x in random_params(rng, BATCH, model))
            p = with_weights(bm_g, p + (torch.as_tensor(kid_factors(kid_rng, BATCH), device=dev),))
            out = bm_g(*p[:3])
            targets.append((out['vertices'], out['joints'], p))
        times = {}
        torch.cuda.reset_peak_memory_stats()
        for what, fn in (('fit', fit_fn), ('value+grad', vg)):
            fn(*targets[0])  # warm-up
            torch.cuda.synchronize()
            lbs_kernels.reset_launch_counts()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            outs = [fn(*t) for t in targets]
            end.record()
            torch.cuda.synchronize()
            times[what] = start.elapsed_time(end) / N_GRAD_TARGETS
            if what == 'value+grad':
                check_launches(dict(lbs_kernels.LAUNCHES), per_grad, N_GRAD_TARGETS,
                               f'phase 14 {name}')
                check_launches(dict(lbs_kernels.TORCH_VJPS), vjps, N_GRAD_TARGETS,
                               f'phase 14 {name} (torch-op backward passes)')
                check_host_covers(lbs_kernels, f'phase 14 {name}')
                for key in total_launches:
                    total_launches[key] += lbs_kernels.LAUNCHES[key]
                for value, grads in outs:
                    if not (torch.isfinite(value) and all(torch.isfinite(g).all() for g in grads)
                            and grads[0].abs().max() > 0):
                        raise AssertionError(f'phase 14 {name}: a gradient is not finite or zero')
            del outs
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f'{name}: value+grad {times["value+grad"]:.2f} ms per B={BATCH} call against the '
            f'fit {times["fit"]:.2f} ms ({times["value+grad"] / times["fit"]:.2f}x; CUDA '
            f'events, mean of {N_GRAD_TARGETS}), peak memory {peak_gib:.2f} GiB, launches per '
            f'value+grad {json.dumps(per_grad)}, torch-op backward passes {json.dumps(vjps)} '
            f'on {smi}')
        del targets
        torch.cuda.empty_cache()
    p = [torch.as_tensor(x, device=dev).requires_grad_() for x in random_params(rng, BATCH)]

    def forward_grad(p=p):
        return torch.autograd.grad(torch.sin(bm(*p)['vertices']).sum(), p)

    forward_grad()
    torch.cuda.synchronize()
    lbs_kernels.reset_launch_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(N_GRAD_TARGETS):
        forward_grad()
    end.record()
    torch.cuda.synchronize()
    check_launches(dict(lbs_kernels.LAUNCHES), dict(lbs_points=1, lbs_points_bwd=1),
                   N_GRAD_TARGETS, 'phase 14 forward gradient')
    check_launches(dict(lbs_kernels.TORCH_VJPS), {}, N_GRAD_TARGETS,
                   'phase 14 forward gradient (torch-op backward passes)')
    check_host_covers(lbs_kernels, 'phase 14 forward gradient')
    for key in total_launches:
        total_launches[key] += lbs_kernels.LAUNCHES[key]
    log(f'smpl forward gradient: {start.elapsed_time(end) / N_GRAD_TARGETS:.2f} ms per B={BATCH}'
        f' call (CUDA events), launches lbs_points 1, lbs_points_bwd 1 on {smi}')
    del p
    torch.cuda.empty_cache()

    # 15. Gradients on the card against the CPU at B=32.
    log(f'== phase 15: gradients, B={PARITY_BATCH}, card vs CPU')
    rng = np.random.default_rng(SEED + 15)  # targets independent of earlier phases' draws
    params = [torch.as_tensor(x, device=dev) for x in random_params(rng, PARITY_BATCH)]
    cpu_fitter = cpu_fitters('smpl', bm, True)[0]
    cpu_bm = cpu_fitter.body_model
    grads = []
    for model_f, ps in ((bm, params), (cpu_bm, [x.cpu() for x in params])):
        ps = [x.detach().requires_grad_() for x in ps]
        grads.append(torch.autograd.grad(torch.sin(model_f(*ps)['vertices']).sum(), ps))
    err = max(((g.cpu() - c).abs().max() / c.abs().max()).item() for g, c in zip(*grads))
    ok = err <= FWD_GRAD_PARITY_REL
    log(f'smpl forward gradient: ok={ok} max|g_card - g_cpu| / max|g_cpu| = {err:.3e} '
        f'(limit {FWD_GRAD_PARITY_REL:g})')
    if not ok:
        failures.append('smpl forward gradient')
    out = bm(*params)
    tv, tj = out['vertices'].detach(), out['joints'].detach()
    grad_parity('smpl headline gradient', port.get_fit_grad_fn(fitter),
                port.get_fit_grad_fn(cpu_fitter), tv, tj, failures)
    cpu_static = port.BodyFitter(cpu_bm,
                                 vertex_weights=static.static_vw, joint_weights=static.static_jw)
    grad_parity('smpl h_static_weights gradient', port.get_fit_grad_fn(static),
                port.get_fit_grad_fn(cpu_static), tv, tj, failures, noise_floor=True)
    for name, bm_o, fitter_o in (('smplx', bm_x, fitter_x), ('smplh16', bm_h, fitter_h)):
        p = [torch.as_tensor(x, device=dev) for x in random_params(rng, PARITY_BATCH, name)]
        out = bm_o(*p)
        tv, tj = out['vertices'].detach(), out['joints'].detach()
        cpu_f = cpu_fitters(name, bm_o)[0]
        grad_parity(f'{name} headline gradient', port.get_fit_grad_fn(fitter_o),
                    port.get_fit_grad_fn(cpu_f), tv, tj, failures, noise_floor=True)
        if name == 'smplx':
            # The large-model route's backward (K7's GEMM, the streamed term's
            # VJP, K12's dh) through one solve, with no rotation fit to
            # amplify rounding: the plain limit. One iteration with the final
            # adjustment for comparison, under the spread rule.
            grad_parity('smplx d_known_pose gradient', known_pose_vg(torch, fitter_o, p[0]),
                        known_pose_vg(torch, cpu_f, p[0]), tv, tj, failures)
            grad_parity('smplx num_iter=1 gradient', port.get_fit_grad_fn(fitter_o, num_iter=1),
                        port.get_fit_grad_fn(cpu_f, num_iter=1), tv, tj, failures,
                        noise_floor=True)

    # The newly differentiable paths, after the checks above so that their
    # targets stay those of earlier runs: SMPL at the plain limit, SMPL-X
    # under the spread rule (GRAD_PARITY_PATHS_X).
    for model, bm_g in (('smpl', bm), ('smplx', bm_x)):
        cpu_bm_g = cpu_fitters(model, bm_g)[0].body_model
        cpu_fs = cpu_path_fitters(port, cpu_bm_g, path_fitters[model])
        p = tuple(torch.as_tensor(x, device=dev) for x in random_params(rng, PARITY_BATCH, model))
        p = with_weights(bm_g, p + (torch.as_tensor(kid_factors(kid_rng, PARITY_BATCH),
                                                    device=dev),))
        out = bm_g(*p[:3])
        tv_g, tj_g = out['vertices'].detach(), out['joints'].detach()
        names = GRAD_PATHS if model == 'smpl' else GRAD_PARITY_PATHS_X
        for name in names:
            grad_parity(f'{model} {name} gradient', path_vg(torch, name, path_fitters[model], p),
                        path_vg(torch, name, cpu_fs, p), tv_g, tj_g, failures,
                        noise_floor=model != 'smpl')
    if failures:
        raise AssertionError(f'the card disagrees with the CPU on: {failures}')

    path_keys = {**KERNELS, **BWD_KERNELS}  # SUMMED is the API's form, on no fitting path
    unlaunched = [key for key in path_keys if total_launches[key] == 0]
    if unlaunched:
        raise AssertionError(f'kernels never launched on the fitting paths: {unlaunched}')

    kernels = []
    for key, (_, source, replaces, _) in path_keys.items():
        # This slice's measurements where the kernel runs on SMPL-X, else SMPL's.
        by_model = results if key in KERNELS else bwd_results
        model = 'smplx' if key in by_model['smplx'] else 'smpl'
        r = by_model[model][key]
        kernels.append(dict(name=key, route='cuda', source=source, replaces=replaces,
                            launches=total_launches[key], max_abs_err=r['max_abs_err'],
                            ms=r['ms'], plain_ms=r['plain_ms'], bound_ms=r['bound_ms'],
                            bound_by=r['bound_by'], library_ms=r['library_ms'], model=model))
    for key in SUMMED:  # the API's form: measured in phase 13, on no fitting path
        r = bwd_results['smpl'][key]
        log(f'{key} (the summed form, no fitting path): kernel {r["ms"]:.3f} ms, twin '
            f'{r["plain_ms"]:.3f} ms, bound {r["bound_ms"]:.3f} ms ({r["bound_by"]}), '
            f'max|kernel - twin| {r["max_abs_err"]:.3e} on {smi}')
    # Where the card's time goes beyond the kernels' bounds, per TPU kernel:
    # launches on the fitting paths x (kernel ms - bound ms), summed over forms.
    excess = collections.defaultdict(float)
    for k in kernels:
        excess[k['replaces']] += k['launches'] * (k['ms'] - k['bound_ms'])
    log('launches x (ms - bound ms) by TPU kernel: ' + ', '.join(
        f'{tpu.split(":")[-1]} {ms:.1f}' for tpu, ms in sorted(excess.items(),
                                                               key=lambda kv: -kv[1])))
    print(json.dumps(dict(kernels=kernels)), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps(dict(ok=True, device=dict(platform='gpu', kind=card,
                                               count=torch.cuda.device_count()))), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
