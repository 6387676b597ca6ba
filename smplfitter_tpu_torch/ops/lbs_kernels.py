"""The fit's kernels: launch wrappers, plain PyTorch twins, launch counts.

Layouts follow ``smplfitter_tpu.ops.lbs_kernels``: per-vertex arrays are
component-major ``(C, V, B)`` with the batch last (contiguous), per-joint
``[R|t]`` entries are ``(12, J, B)`` with leading index ``a * 4 + c``.

Every wrapper dispatches on the device of its inputs. CPU tensors go to the
kernel's plain twin (``*_ref``, written in PyTorch ops in this module): that
is how the CPU tests hold the port to the JAX package. CUDA tensors go to the
hand-written kernel in ``csrc/`` (built on first use, see ``_build.py``), or
the wrapper raises; there is no fallback from one to the other. Each kernel
launch adds one to ``LAUNCHES[<name>]``; a fit-weighted (ω) form counts
under its own key, the unweighted key with ``_w`` appended.

| wrapper                     | CUDA source                 | replaces (JAX package)           |
|-----------------------------|-----------------------------|----------------------------------|
| lbs_points                  | csrc/lbs_points.cu          | _lbs_points_kernel (K1)          |
| rhs_moments_h               | csrc/rhs_moments.cu         | _rhs_kernel, emit_homog (K2)     |
| rhs_moments                 | csrc/rhs_moments.cu         | _rhs_kernel, plain / scale (K2)  |
| rhs_moments_cached          | csrc/rhs_moments.cu         | _rhs_kernel, cached (K2)         |
| gram_assembly               | csrc/gram_assembly.cu       | _gram_kernel (K3)                |
| recon_part_sums_cached_lm   | csrc/recon_part_sums.cu     | _recon_cached_kernel (K4)        |
| part_sums_vm_lm             | csrc/part_sums.cu           | _part_sums_kernel (K5)           |
| recon_part_sums_lm          | csrc/recon_lbs_part_sums.cu | _recon_part_sums_kernel (K6)     |
| posed_template_lm           | csrc/posed_template.cu      | _posed_template_kernel (K7)      |
| term1                       | csrc/term1.cu               | _term1_kernel (K8)               |
| wgram_moments               | csrc/wgram.cu               | _wgram_kernel (K9)               |

``gram_assembly`` runs K3 at small J and, where the JAX package streams
term1 (SMPL-X, SMPL+H), K8 plus :func:`gram_mparts_ref` in PyTorch ops, as
the JAX package leaves those pieces to XLA.

K1, K2 and K9 walk a cover of the vertices (:class:`BlendSegments`, built
once per model on the host by :func:`wgram_cover`: segments of at most 32
vertices of one body part, each with its active joints) and blend over each
segment's joints only; their wrappers take it as ``cover=`` (None builds one
from ``weights_pad`` on the host at every call, counted in ``HOST_COVERS``).
K6 walks the part index's segments and lists (:class:`PartIndex`). Their
backward kernels walk the same: K10 the cover its K1 call walked (``cover=``
again, kept by the autograd Function; None builds one, counted under
``lbs_points_bwd``), K14 the part index's 32-vertex tiles; both take the posed
template from K7 and dfeat from a split-K GEMM (csrc/dfeat_gemm.cu) over a
(3, V_pad, B) workspace the kernel's front writes.

Fit weights ω reach K2 as the static column (V_pad, 1) of a weighted fitter,
and K4, K5 and K6 as that column or as per-call weights (V, B); K9 takes
per-call weights only. Each form is a compile-time variant of its kernel.

Gradients follow the JAX package's custom VJPs. Where it has one, the wrapper
is a ``torch.autograd.Function`` whose backward is a kernel too:

| wrapper                    | backward wrapper           | replaces (JAX package)            |
|----------------------------|----------------------------|-----------------------------------|
| lbs_points                 | lbs_points_bwd             | _lbs_points_bwd_kernel (K10)      |
| rhs_moments_h, rhs_moments | rhs_moments_bwd            | _rhs_bwd_kernel (K11)             |
| rhs_moments_cached         | rhs_moments_cached_bwd     | _rhs_cached_bwd_kernel (K12)      |
| recon_part_sums_cached_lm  | recon_part_sums_cached_bwd | _recon_cached_bwd_kernel (K13)    |
| recon_part_sums_lm         | recon_part_sums_bwd        | _recon_part_sums_bwd_kernel (K14) |
| part_sums_vm_lm            | part_sums_bwd              | _part_sums_bwd_kernel (K15)       |
| gram_assembly (K3), term1  | PyTorch ops                | the JAX package's XLA VJPs        |
| posed_template_lm          | PyTorch ops                | the JAX package's XLA VJP         |

The backward kernels are in csrc/lbs_points_bwd.cu (K10), csrc/rhs_bwd.cu
(K11, K12), csrc/recon_bwd.cu (K13), csrc/recon_lbs_part_sums_bwd.cu (K14)
and csrc/part_sums_bwd.cu (K15). The K2, K4, K5 and K6 rows hold for the
unweighted form and the static-ω one. K15 has a summed form for a
batch-constant reference (3, V_a, 1), whose cotangent sums over the batch.

Each backward wrapper, like a forward one, runs its plain twin (``*_bwd_ref``,
the explicit formula) on CPU tensors and its kernel on CUDA tensors, counting
launches under its own key.

The forms the JAX package gives no custom VJP, which it differentiates
through its XLA formulation, keep their forward kernel and take their
backward in PyTorch ops (:class:`_ChunkedVjp`: the VJP of the twin's formula,
recomputed one vertex chunk at a time), counted in ``TORCH_VJPS`` (as are
the backward passes of K3, K7 and K8, under their LAUNCHES keys):

| wrapper (forms)                                | TORCH_VJPS key                |
|------------------------------------------------|-------------------------------|
| rhs_moments, scale=True (unweighted, ω)        | rhs_moments_scale[_w]         |
| rhs_moments_cached, scale=True (unweighted, ω) | rhs_moments_cached_scale[_w]  |
| recon_part_sums_cached_lm, per-call ω          | recon_part_sums_cached_call_w |
| part_sums_vm_lm, per-call ω                    | part_sums_call_w              |
| recon_part_sums_lm, per-call ω                 | recon_part_sums_call_w        |
| wgram_moments (K9)                             | wgram                         |

They differentiate the targets, the [R|t] entries, the features or cached
template, the Jacobian operands and means of K9, and the weights ω. Operands
every backward treats as constants (skinning weights, template projectors,
shape directions, moments, a static ω of a kernel backward, the part index)
get no gradient; should one require grad, the CPU runs the twin and the card
raises ``NotImplementedError``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from . import _build

LAUNCHES = {
    'lbs_points': 0,
    'rhs_moments_h': 0,
    'rhs_moments': 0,
    'rhs_moments_scale': 0,
    'rhs_moments_cached': 0,
    'rhs_moments_cached_scale': 0,
    'gram_assembly': 0,
    'recon_part_sums_cached': 0,
    'part_sums': 0,
    'recon_part_sums': 0,
    'posed_template': 0,
    'term1': 0,
    'rhs_moments_h_w': 0,
    'rhs_moments_w': 0,
    'rhs_moments_scale_w': 0,
    'rhs_moments_cached_w': 0,
    'rhs_moments_cached_scale_w': 0,
    'recon_part_sums_cached_w': 0,
    'part_sums_w': 0,
    'recon_part_sums_w': 0,
    'wgram': 0,
    'lbs_points_bwd': 0,
    'rhs_moments_h_bwd': 0,
    'rhs_moments_bwd': 0,
    'rhs_moments_cached_bwd': 0,
    'recon_part_sums_cached_bwd': 0,
    'rhs_moments_h_bwd_w': 0,
    'rhs_moments_bwd_w': 0,
    'rhs_moments_cached_bwd_w': 0,
    'recon_part_sums_cached_bwd_w': 0,
    'part_sums_bwd': 0,
    'part_sums_bwd_sum': 0,
    'part_sums_bwd_w': 0,
    'part_sums_bwd_sum_w': 0,
    'recon_part_sums_bwd': 0,
    'recon_part_sums_bwd_w': 0,
}

# Covers built on the host because a caller passed none (a copy of the
# skinning weights from the card at every such call): by wrapper.
HOST_COVERS = {'lbs_points': 0, 'rhs_moments': 0, 'wgram': 0, 'lbs_points_bwd': 0}

# Backward passes in torch ops, one count per backward call: K3, K7 and K8,
# whose JAX VJPs are XLA, and the forms the JAX package differentiates through
# its XLA formulation (no custom VJP there; per-call fit weights count under
# '_call_w').
TORCH_VJPS = {
    'gram_assembly': 0,
    'posed_template': 0,
    'term1': 0,
    'rhs_moments_scale': 0,
    'rhs_moments_scale_w': 0,
    'rhs_moments_cached_scale': 0,
    'rhs_moments_cached_scale_w': 0,
    'recon_part_sums_cached_call_w': 0,
    'part_sums_call_w': 0,
    'recon_part_sums_call_w': 0,
    'wgram': 0,
}

# Row padding of the per-vertex constant operands (weights_pad, consts, sd_cm).
# The kernels mask by row index and need none; it is kept equal to the JAX
# package's vertex chunk so the precomputed fields compare directly.
VC = 256

_TV = 64  # vertex tile of the backward LBS kernels K11-K13 (csrc/lbs_tile.cuh)
_TB = 64  # batch tile of the backward LBS kernels K11-K13
_SEG_TB = 128  # batch columns per block of the kernels that walk a cover (csrc/template_tile.cuh)
_PART_TILE = 32  # vertices per tile of a part index's segments (K14's front, csrc/bwd_front.cuh)
_SEG = 512  # max vertices per part segment of the recon kernel
_WGRAM_SEG = 32  # max vertices per segment of K9's cover (csrc/wgram.cu: one tile)
_BWD_MAXJ = 64  # joints of one reduction pass of K11-K13 (csrc/lbs_bwd.cuh)
_SUM_COLS = 256  # batch columns per split of K15's summed form (csrc/part_sums_bwd.cu)
_VJP_VCHUNK = 512  # vertices per step of a backward in torch ops (bounds its memory)
_TERM1_TILE = (256, 128)  # K8's block tile: rows of G1, batch columns (csrc/term1.cu)
_TERM1_KB, _TERM1_JS = 8, 5  # k and j values per k stage of K8
_DFEAT_TILE = (128, 256)  # the dfeat GEMM's block tile: features, batch columns (csrc/dfeat_gemm.cu)
_DFEAT_KT = 16  # k rows per stage of the dfeat GEMM

# The JAX package's route for the shape solve of models whose pose template
# has more features than this (SMPL-X F=487, SMPL+H F=460): the posed template
# once per solve as its own kernel (K7), read by K2's cached form and K4,
# instead of the in-kernel homog dot (lbs_kernels.HOMOG_GEMM_MIN_F there).
HOMOG_GEMM_MIN_F = 320

# The JAX package's switch between the two Gramian routes: where Ksd takes
# more than this many bytes (J3^2 E^2 4; SMPL 2.07 MB, SMPL-X 27.9 MB) term1
# is streamed by its own kernel (K8) and the rest of G is plain tensor ops
# (lbs_kernels._gram_xblock there); below it one fused kernel (K3).
TERM1_STREAM_MIN_BYTES = 2.75 * 2 ** 20


def reset_launch_counts() -> None:
    """Zero LAUNCHES, TORCH_VJPS and HOST_COVERS."""
    for counts in (LAUNCHES, TORCH_VJPS, HOST_COVERS):
        for name in counts:
            counts[name] = 0


def to_vertex_major(x: torch.Tensor) -> torch.Tensor:
    """(B, V, 3) -> (3, V, B), contiguous, canonical vertex order."""
    return x.permute(2, 1, 0).contiguous()


def from_vertex_major(x_vm: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """(3, V_pad, B) -> (B, V, 3) view of the first ``num_vertices`` rows."""
    return x_vm[:, :num_vertices].permute(2, 1, 0)


# ---------------------------------------------------------------------------
# Argument checks and launch plumbing
# ---------------------------------------------------------------------------


def _on_cuda(name: str, **tensors) -> bool:
    """Validate dtype/contiguity/device of a kernel's operands; True for CUDA."""
    devices = set()
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f'{name}: {arg} must be a torch.Tensor')
        if t.dtype != torch.float32:
            raise TypeError(f'{name}: {arg} must be float32, got {t.dtype}')
        if not t.is_contiguous():
            raise ValueError(f'{name}: {arg} must be contiguous')
        devices.add(t.device)
    if len(devices) != 1:
        raise ValueError(f'{name}: operands on several devices: {sorted(map(str, devices))}')
    device = devices.pop()
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{name}: unsupported device {device}')
    return device.type == 'cuda'


def _expect(name: str, arg: str, t: torch.Tensor, shape) -> None:
    if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f'{name}: {arg} has shape {tuple(t.shape)}, expected {shape}')


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _vertex_splits(Vp: int, B: int, device) -> tuple[int, int]:
    """(vertex tiles per block, number of vertex splits) of the backward
    LBS kernels: enough splits of the vertex axis that the grid holds about
    four blocks per SM."""
    n_vtiles = -(-Vp // _TV)
    grid_x = -(-B // _TB)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(n_vtiles, math.ceil(4 * sms / grid_x)))
    tiles_per_block = -(-n_vtiles // want)
    return tiles_per_block, -(-n_vtiles // tiles_per_block)


def _segment_runs(n_seg: int, B: int, device, blocks_per_sm: int) -> tuple[int, int]:
    """(segments per block, number of runs) of a kernel that walks a cover:
    runs of the cover's segments such that the grid holds at most
    ``blocks_per_sm`` blocks per SM (K2 and the fronts of K10 and K14: one
    wave, one block per SM, so their per-run partials stay few; K1: four
    waves of two blocks per SM). No segments: no runs."""
    grid_x = -(-B // _SEG_TB)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, min(n_seg, blocks_per_sm * sms // grid_x))
    per_block = max(1, -(-n_seg // want))
    return per_block, -(-n_seg // per_block)


def dfeat_splits(F: int, B: int, Vp: int, device) -> int:
    """Splits of the dfeat GEMM's K = 3 V_pad sum (K10, K14): as many as fill
    one wave of the card (one resident block per SM) with the grid's
    (feature, batch) tiles, at most one per 16-row k stage (2 at SMPL-X
    b4096 on 132 SMs, 4 at SMPL)."""
    tiles = -(-F // _DFEAT_TILE[0]) * -(-B // _DFEAT_TILE[1])
    stages = -(-3 * Vp // _DFEAT_KT)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(stages, sms // max(tiles, 1)))


def _f32(device, *shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device)


def _walk_cover(name: str, cover, weights_pad, rows: int, device, cuda: bool):
    """The cover a kernel walks: ``cover``, or where a call on the card
    passes None, one of every row of ``weights_pad`` built on the host
    (counted in HOST_COVERS under ``name``); None for a CPU call without
    one (the twin needs none). It must hold every vertex below ``rows`` and
    none at or past V_pad."""
    if cover is None:
        if not cuda:
            return None
        HOST_COVERS[name] += 1
        cover = wgram_cover(weights_pad.detach().cpu().numpy(), weights_pad.shape[0], device)
    if not rows <= cover.covers <= weights_pad.shape[0]:
        raise ValueError(f'{name}: the cover holds the vertices below {cover.covers}; the call '
                         f'reads {rows} and has {weights_pad.shape[0]} rows')
    _index_tensors(name, device, cover.verts, cover.seg_offset, cover.joints, cover.joint_offset)
    return cover


def _zero_past_cover(name: str, cover, arg: str, t: torch.Tensor) -> None:
    """Rows (axis 1 of a (C, V_pad, ...) operand, axis 0 of a (V_pad, J) one)
    from ``cover.covers`` on, which the kernel leaves out (its outputs there
    are zeros), must be zero in ``t``. Checked once per cover and tensor
    version (a copy from the card)."""
    dim = 0 if arg == 'weights_pad' else 1
    if cover.covers >= t.shape[dim]:
        return
    key = (arg, t.data_ptr(), t._version)
    if key in cover.zero_past:
        return
    if bool(_rows(t, dim, cover.covers, t.shape[dim]).any()):
        raise ValueError(f'{name}: {arg} has nonzero rows at or past {cover.covers}, which the '
                         'cover leaves out')
    cover.zero_past.add(key)


def _omega_strides(name: str, omega, v_t: int, B: int, Vp: int, static_only: bool = False):
    """Check a fit-weight operand and give its kernel addressing: (rows,
    row stride, batch stride). The static column is (V_pad, 1), read with a
    batch stride of 0; per-call weights are (V_t, B), one per target row."""
    if omega.dim() == 2 and omega.shape == (Vp, 1):
        return Vp, 1, 0
    if not static_only and omega.dim() == 2 and omega.shape == (v_t, B):
        return v_t, B, 1
    want = f'({Vp}, 1)' if static_only else f'({Vp}, 1) or ({v_t}, {B})'
    raise ValueError(f'{name}: omega has shape {tuple(omega.shape)}, expected {want}')


def _omega_rows(omega, v: int) -> torch.Tensor:
    """The first v rows of a fit-weight operand (zero past its own rows):
    (v, 1) static or (v, B) per call."""
    if omega.shape[0] >= v:
        return omega[:v]
    return torch.cat([omega, omega.new_zeros((v - omega.shape[0], omega.shape[1]))])


def _apply_blend(blend: torch.Tensor, homog: torch.Tensor) -> torch.Tensor:
    """pos_a = sum_c blend[a*4+c] homog_c + blend[a*4+3] -> (3, V, B)."""
    return torch.stack([
        blend[a * 4] * homog[0] + blend[a * 4 + 1] * homog[1]
        + blend[a * 4 + 2] * homog[2] + blend[a * 4 + 3]
        for a in range(3)
    ])


def _project_rbar(blend: torch.Tensor, field: torch.Tensor) -> torch.Tensor:
    """(Rbar^T field)_c = sum_a blend[a*4+c] field_a -> (3, V, B)."""
    return torch.stack([sum(blend[a * 4 + c] * field[a] for a in range(3)) for c in range(3)])


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def _twin_for_constant_grads(name: str, cuda: bool, *constants) -> bool:
    """True where an operand that the backward treats as a constant requires
    grad: on the CPU the wrapper then runs its autograd-transparent twin
    instead of its Function; on the card it raises."""
    if not _needs_grad(*constants):
        return False
    if cuda:
        raise NotImplementedError(
            f'{name}: no gradient on the card for an operand that the backward treats as a '
            'constant (skinning weights, templates, shape directions, moments, static fit '
            'weights, the part index)')
    return True


def _rows(x: torch.Tensor, dim: int, v0: int, v1: int) -> torch.Tensor:
    """Rows [v0, v1) of x along its vertex axis ``dim`` (a view)."""
    return x[(slice(None),) * dim + (slice(v0, v1),)]


class _ChunkedVjp(torch.autograd.Function):
    """A kernel form whose backward is torch ops, as the JAX package
    differentiates the forms without a custom VJP through its XLA
    formulation: the forward runs ``run`` (the kernel on CUDA tensors, the
    twin on CPU ones); the backward recomputes ``chunk_fn``, the twin's
    formula, under autograd on ``_VJP_VCHUNK`` vertices at a time and adds
    up the chunks' VJPs. Every output is a sum over the first ``n_rows``
    vertices, so the VJP splits exactly over chunks, and one chunk's graph
    bounds the memory. ``vdims`` gives each operand's vertex axis (None: not
    per vertex); ``diff`` the operands that get a gradient; each backward
    counts one under ``TORCH_VJPS[key]``."""

    @staticmethod
    def forward(ctx, key, run, chunk_fn, n_rows, vdims, diff, *operands):
        ctx.key, ctx.chunk_fn, ctx.n_rows, ctx.vdims, ctx.diff = (
            key, chunk_fn, n_rows, vdims, diff)
        ctx.save_for_backward(*operands)
        return run(*operands)

    @staticmethod
    @once_differentiable
    def backward(ctx, *cots):
        ops = ctx.saved_tensors
        want = [i for i in ctx.diff if ctx.needs_input_grad[6 + i]]
        grads = [None] * len(ops)
        if not want:
            return (None,) * (6 + len(ops))
        TORCH_VJPS[ctx.key] += 1
        for i in want:
            grads[i] = torch.zeros_like(ops[i])
        for v0 in range(0, ctx.n_rows, _VJP_VCHUNK):
            v1 = min(ctx.n_rows, v0 + _VJP_VCHUNK)
            with torch.enable_grad():
                xs = [o if o is None or d is None else _rows(o, d, v0, v1)
                      for o, d in zip(ops, ctx.vdims)]
                xs = [x.detach().requires_grad_() if i in want else x for i, x in enumerate(xs)]
                outs = ctx.chunk_fn(*xs)
                pairs = [(o, c) for o, c in zip(outs, cots) if o.requires_grad]
                gs = torch.autograd.grad([o for o, _ in pairs], [xs[i] for i in want],
                                         [c for _, c in pairs], allow_unused=True)
            for i, g in zip(want, gs):
                if g is not None:
                    d = ctx.vdims[i]
                    (grads[i] if d is None else _rows(grads[i], d, v0, v1)).add_(g)
        return (None,) * 6 + tuple(grads)


# ---------------------------------------------------------------------------
# K1: extended LBS -> points
# ---------------------------------------------------------------------------


def lbs_points_ref(pj_cm, feat_cols, weights_pad, consts_pad):
    """Plain twin of :func:`lbs_points`."""
    homog = posed_template_ref(feat_cols, consts_pad)
    blend = torch.einsum('vj,xjb->xvb', weights_pad, pj_cm)
    return _apply_blend(blend, homog).contiguous()


def lbs_points(pj_cm, feat_cols, weights_pad, consts_pad, cover: BlendSegments | None = None):
    """Extended LBS: the per-joint ``[R|t]`` (12, J, B) blended by the skinning
    weights (V_pad, J) and applied to the homogeneous template
    ``consts_pad[c] @ feat_cols`` (c = 0..2; channel 3 is 1) -> (3, V_pad, B).

    ``cover`` (:func:`wgram_cover` of ``weights_pad``, as ``BodyModel`` and
    the fitter's GramData hold it) is the vertex cover the kernel walks; rows
    from ``cover.covers`` on must have zero weights and come out zero. None
    builds a cover of every row on the host (a copy from the card at every
    call). The twin ignores it."""
    name = 'lbs_points'
    cuda = _on_cuda(name, pj_cm=pj_cm, feat_cols=feat_cols, weights_pad=weights_pad,
                    consts_pad=consts_pad)
    _, J, B = pj_cm.shape
    F = feat_cols.shape[0]
    Vp = weights_pad.shape[0]
    _expect(name, 'pj_cm', pj_cm, (12, J, B))
    _expect(name, 'feat_cols', feat_cols, (F, B))
    _expect(name, 'weights_pad', weights_pad, (Vp, J))
    _expect(name, 'consts_pad', consts_pad, (None, Vp, F))
    if consts_pad.shape[0] < 3:
        raise ValueError(f'{name}: consts_pad needs at least 3 channels')
    if _twin_for_constant_grads(name, cuda, weights_pad, consts_pad):
        return lbs_points_ref(pj_cm, feat_cols, weights_pad, consts_pad)
    cover = _walk_cover(name, cover, weights_pad, 0, pj_cm.device, cuda)
    if cover is not None:
        _zero_past_cover(name, cover, 'weights_pad', weights_pad)
    return _LbsPoints.apply(pj_cm, feat_cols, weights_pad, consts_pad, cover)


def _lbs_points_run(pj_cm, feat_cols, weights_pad, consts_pad, cover):
    """K1 on CUDA tensors, its twin on CPU ones (operands checked)."""
    if not pj_cm.is_cuda:
        return lbs_points_ref(pj_cm, feat_cols, weights_pad, consts_pad)
    _, J, B = pj_cm.shape
    F, Vp = feat_cols.shape[0], weights_pad.shape[0]
    out = torch.empty((3, Vp, B), dtype=torch.float32, device=pj_cm.device)
    per_block, _ = _segment_runs(cover.n_seg, B, pj_cm.device, 8)
    err = _build.library().lbs_points_launch(
        _ptr(pj_cm), _ptr(feat_cols), _ptr(weights_pad), _ptr(consts_pad), _ptr(cover.verts),
        _ptr(cover.seg_offset), _ptr(cover.joints), _ptr(cover.joint_offset), _ptr(out),
        J, B, F, Vp, cover.n_seg, per_block, cover.covers, _stream(out))
    _build.check(err, 'lbs_points')
    LAUNCHES['lbs_points'] += 1
    return out


class _LbsPoints(torch.autograd.Function):
    """K1 with K10 as its backward (the JAX package's _lbs_points_diff); the
    backward walks the forward's cover."""

    @staticmethod
    def forward(ctx, pj_cm, feat_cols, weights_pad, consts_pad, cover=None):
        ctx.cover = cover
        ctx.save_for_backward(pj_cm, feat_cols, weights_pad, consts_pad)
        return _lbs_points_run(pj_cm, feat_cols, weights_pad, consts_pad, cover)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        dpj, dfeat = lbs_points_bwd(g.contiguous(), *ctx.saved_tensors, cover=ctx.cover)
        return dpj, dfeat, None, None, None


# ---------------------------------------------------------------------------
# K10: backward of the extended LBS
# ---------------------------------------------------------------------------


def lbs_points_bwd_ref(g, pj_cm, feat_cols, weights_pad, consts_pad):
    """Plain twin of :func:`lbs_points_bwd`."""
    homog = posed_template_ref(feat_cols, consts_pad)
    blend = torch.einsum('vj,xjb->xvb', weights_pad, pj_cm)
    dblend = torch.stack([g[a] * homog[c] if c < 3 else g[a] for a in range(3) for c in range(4)])
    dpj = torch.einsum('vj,xvb->xjb', weights_pad, dblend)
    dfeat = torch.einsum('cvf,cvb->fb', consts_pad[:3], _project_rbar(blend, g))
    return dpj.contiguous(), dfeat.contiguous()


def lbs_points_bwd(g, pj_cm, feat_cols, weights_pad, consts_pad,
                   cover: BlendSegments | None = None):
    """The VJP of :func:`lbs_points` for the cotangent g (3, V_pad, B) of the
    points: dpj (12, J, B) = sum_v w_vj g_a h_c (h_3 = 1; rows a*4+c) and
    dfeat (F, B) = sum_c consts_c^T (Rbar^T g)_c, h = the posed template and
    Rbar the blended rotation. The homogeneous channel 3 is the constant 1 of
    the forward and adds nothing to dfeat.

    ``cover`` is the vertex cover the kernel walks, as for :func:`lbs_points`
    (the forward's, which ``_LbsPoints`` passes on): rows from
    ``cover.covers`` on must have zero weights. None builds one on the host
    at every call on the card (counted in HOST_COVERS). The twin ignores it.
    The kernel also takes two (3, V_pad, B) workspaces: the posed template
    and Rbar^T g."""
    name = 'lbs_points_bwd'
    cuda = _on_cuda(name, g=g, pj_cm=pj_cm, feat_cols=feat_cols, weights_pad=weights_pad,
                    consts_pad=consts_pad)
    _, J, B = pj_cm.shape
    F = feat_cols.shape[0]
    Vp = weights_pad.shape[0]
    _expect(name, 'g', g, (3, Vp, B))
    _expect(name, 'feat_cols', feat_cols, (F, B))
    _expect(name, 'weights_pad', weights_pad, (Vp, J))
    _expect(name, 'consts_pad', consts_pad, (None, Vp, F))
    if consts_pad.shape[0] < 3:
        raise ValueError(f'{name}: consts_pad needs at least 3 channels')
    if not cuda:
        return lbs_points_bwd_ref(g, pj_cm, feat_cols, weights_pad, consts_pad)
    dev = g.device
    cover = _walk_cover(name, cover, weights_pad, 0, dev, cuda)
    _zero_past_cover(name, cover, 'weights_pad', weights_pad)
    per_run, n_runs = _segment_runs(cover.n_seg, B, dev, 1)
    splits = dfeat_splits(F, B, Vp, dev)
    out = _f32(dev, 12 * J + F, B)
    H, U = _f32(dev, 3, Vp, B), _f32(dev, 3, Vp, B)
    part = _f32(dev, n_runs, 12 * J, B)
    part_feat = _f32(dev, splits, F, B) if splits > 1 else None
    err = _build.library().lbs_points_bwd_launch(
        _ptr(g), _ptr(pj_cm), _ptr(feat_cols), _ptr(weights_pad), _ptr(consts_pad),
        _ptr(cover.verts), _ptr(cover.seg_offset), _ptr(cover.joints), _ptr(cover.joint_offset),
        _ptr(H), _ptr(U), _ptr(part), None if part_feat is None else _ptr(part_feat), _ptr(out),
        J, B, F, Vp, cover.n_seg, cover.covers, per_run, splits, _stream(out))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out[:12 * J].view(12, J, B), out[12 * J:]


# ---------------------------------------------------------------------------
# K7: the posed template of the large-F shape solve
# ---------------------------------------------------------------------------


def posed_template_ref(feat_cols, consts_pad):
    """Plain twin of :func:`posed_template_lm`."""
    return torch.einsum('cvf,fb->cvb', consts_pad[:3], feat_cols).contiguous()


def posed_template_lm(feat_cols, consts_pad):
    """The posed zero-beta template homog_c = consts_c @ feat (c = 0..2),
    component-major (3, V_pad, B), for feat (F, B) and consts (>= 3, V_pad, F):
    computed once per shape solve of a large-F model and read by
    :func:`rhs_moments_cached` and :func:`recon_part_sums_cached_lm`."""
    name = 'posed_template'
    cuda = _on_cuda(name, feat_cols=feat_cols, consts_pad=consts_pad)
    F, B = feat_cols.shape
    Vp = consts_pad.shape[1]
    _expect(name, 'feat_cols', feat_cols, (F, B))
    _expect(name, 'consts_pad', consts_pad, (None, Vp, F))
    if consts_pad.shape[0] < 3:
        raise ValueError(f'{name}: consts_pad needs at least 3 channels')
    if _twin_for_constant_grads(name, cuda, consts_pad):
        return posed_template_ref(feat_cols, consts_pad)
    return _PosedTemplate.apply(feat_cols, consts_pad)


class _PosedTemplate(torch.autograd.Function):
    """K7; its backward is linear in the cotangent, dfeat = sum_c consts_c^T
    dh_c: one GEMM over the (channel, vertex) rows, as the JAX package leaves
    it to XLA (_posed_template_bwd)."""

    @staticmethod
    def forward(ctx, feat_cols, consts_pad):
        ctx.save_for_backward(consts_pad)
        if not feat_cols.is_cuda:
            return posed_template_ref(feat_cols, consts_pad)
        F, B = feat_cols.shape
        Vp = consts_pad.shape[1]
        out = torch.empty((3, Vp, B), dtype=torch.float32, device=feat_cols.device)
        err = _build.library().posed_template_launch(
            _ptr(feat_cols), _ptr(consts_pad), _ptr(out), F, B, Vp, _stream(out))
        _build.check(err, 'posed_template')
        LAUNCHES['posed_template'] += 1
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dh):
        TORCH_VJPS['posed_template'] += 1
        (consts_pad,) = ctx.saved_tensors
        _, Vp, F = consts_pad.shape
        consts3 = consts_pad[:3].reshape(3 * Vp, F)
        return consts3.T @ dh.reshape(3 * Vp, -1), None


# ---------------------------------------------------------------------------
# K2: residual moments of the shape solve (emit-homog, plain, scale and cached forms)
# ---------------------------------------------------------------------------


def _rhs_twin(tgt_vm, pj_cm, homog, weights_pad, sd_cm, scale: bool, omega=None):
    """The forms of K2 in plain PyTorch, from the posed template homog
    (3, V_pad, B): (r, y[, rt, yt, sc]). A static ω column (V_pad, 1)
    weights the residual, and in the scale form the targets and the three
    second moments."""
    v_t = tgt_vm.shape[1]
    blend = torch.einsum('vj,xjb->xvb', weights_pad, pj_cm)
    pos = _apply_blend(blend, homog)
    t = torch.zeros_like(pos)
    t[:, :v_t] = tgt_vm
    pos_t = torch.zeros_like(pos)
    pos_t[:, :v_t] = pos[:, :v_t]
    b = t - pos_t
    om = None
    if omega is not None:
        om = torch.zeros((pos.shape[1], 1), dtype=pos.dtype, device=pos.device)
        om[:v_t] = omega[:v_t]
        b = b * om

    def moments(field):  # y (3, J, B) and r (E, B) of a per-vertex field
        y = torch.einsum('vj,avb->ajb', weights_pad, field)
        g = torch.stack([sum(blend[a * 4 + c] * field[a] for a in range(3)) for c in range(3)])
        return torch.einsum('cve,cvb->eb', sd_cm, g).contiguous(), y.contiguous()

    r, y = moments(b)
    out = (r, y)
    if scale:
        tw = t if om is None else t * om
        rt, yt = moments(tw)
        sc = torch.stack([(tw * t).sum(dim=(0, 1)), (tw * pos_t).sum(dim=(0, 1)),
                          ((pos_t if om is None else pos_t * om) * pos_t).sum(dim=(0, 1))])
        out += (rt, yt, sc)
    return out


def rhs_moments_h_ref(tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm, omega=None):
    """Plain twin of :func:`rhs_moments_h`."""
    homog = posed_template_ref(feat_cols, consts_pad)
    return _rhs_twin(tgt_vm, pj_cm, homog, weights_pad, sd_cm, False, omega) + (homog,)


def rhs_moments_ref(tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm,
                    scale: bool = False, omega=None):
    """Plain twin of :func:`rhs_moments`."""
    return _rhs_twin(tgt_vm, pj_cm, posed_template_ref(feat_cols, consts_pad), weights_pad,
                     sd_cm, scale, omega)


def rhs_moments_cached_ref(tgt_vm, pj_cm, homog_vm, weights_pad, sd_cm, scale: bool = False,
                           omega=None):
    """Plain twin of :func:`rhs_moments_cached`."""
    return _rhs_twin(tgt_vm, pj_cm, homog_vm, weights_pad, sd_cm, scale, omega)


def _rhs_call(name, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm, homog_vm,
              emit_homog: bool, scale: bool, omega=None, cover=None):
    """Checks, then one K2 form: its kernel on CUDA tensors, its twin on CPU
    ones. The cached form takes ``homog_vm`` in place of feat and consts; a
    static ω column selects the weighted form (its own launch count). On the
    card the kernel walks ``cover`` (None: built on the host)."""
    cached = homog_vm is not None
    if omega is not None:
        name += '_w'
    extra = {} if omega is None else dict(omega=omega)
    if cached:
        cuda = _on_cuda(name, tgt_vm=tgt_vm, pj_cm=pj_cm, homog_vm=homog_vm,
                        weights_pad=weights_pad, sd_cm=sd_cm, **extra)
    else:
        cuda = _on_cuda(name, tgt_vm=tgt_vm, pj_cm=pj_cm, feat_cols=feat_cols,
                        weights_pad=weights_pad, consts_pad=consts_pad, sd_cm=sd_cm, **extra)
    _, J, B = pj_cm.shape
    Vp = weights_pad.shape[0]
    v_t = tgt_vm.shape[1]
    E = sd_cm.shape[2]
    _expect(name, 'tgt_vm', tgt_vm, (3, v_t, B))
    _expect(name, 'pj_cm', pj_cm, (12, J, B))
    _expect(name, 'weights_pad', weights_pad, (Vp, J))
    _expect(name, 'sd_cm', sd_cm, (3, Vp, E))
    if cached:
        F = 0
        _expect(name, 'homog_vm', homog_vm, (3, Vp, B))
    else:
        F = feat_cols.shape[0]
        _expect(name, 'feat_cols', feat_cols, (F, B))
        _expect(name, 'consts_pad', consts_pad, (None, Vp, F))
        if consts_pad.shape[0] < 3:
            raise ValueError(f'{name}: consts_pad needs at least 3 channels')
    if v_t > Vp:
        raise ValueError(f'{name}: target rows {v_t} exceed V_pad {Vp}')
    if omega is not None:
        _omega_strides(name, omega, v_t, B, Vp, static_only=True)
    if cuda and E > 32:
        raise ValueError(f'{name}: the kernel takes E <= 32, got {E}')
    cover = _walk_cover('rhs_moments', cover, weights_pad, v_t, tgt_vm.device, cuda)
    if cover is not None and emit_homog:
        _zero_past_cover(name, cover, 'consts_pad', consts_pad[:3])
    args = (name, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm, homog_vm, emit_homog,
            scale, omega, cover)
    if scale:  # no backward kernel: the VJP of the twin in torch ops (ω included)
        if _twin_for_constant_grads(name, cuda, weights_pad, consts_pad, sd_cm):
            return _rhs_run(*args)
        return _rhs_scale_vjp(*args[:8], omega, cover)
    if _twin_for_constant_grads(name, cuda, weights_pad, consts_pad, sd_cm, omega):
        return _rhs_run(*args)
    return _RhsMoments.apply(*args)


def _rhs_scale_vjp(name, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm, homog_vm,
                   omega, cover=None):
    """K2's scale forms (plain or cached, unweighted or static ω) as a
    _ChunkedVjp: tgt, pj, feat or the cached template, and ω differentiate."""
    cached = homog_vm is not None

    def run(tgt, pj, feat, w, consts, sd, homog, om):
        return _rhs_run(name, tgt, pj, feat, w, consts, sd, homog, False, True, om, cover)

    def chunk(tgt, pj, feat, w, consts, sd, homog, om):
        h = homog if cached else posed_template_ref(feat, consts)
        return _rhs_twin(tgt, pj, h, w, sd, True, om)

    return _ChunkedVjp.apply(name, run, chunk, tgt_vm.shape[1], (1, None, None, 0, 1, 1, 1, 0),
                             (0, 1, 2, 6, 7), tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad,
                             sd_cm, homog_vm, omega)


class _RhsMoments(torch.autograd.Function):
    """K2's emit-homog, plain and cached forms (unweighted or static ω) with
    K11 (emit-homog, plain) or K12 (cached) as their backward: the JAX
    package's _rhs_h_diff, _rhs_moments_diff, _rhs_c_diff and their _w forms."""

    @staticmethod
    def forward(ctx, name, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm, homog_vm,
                emit_homog, scale, omega, cover=None):
        ctx.emit_homog = emit_homog
        ctx.save_for_backward(tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm, homog_vm,
                              omega)
        return _rhs_run(name, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm, homog_vm,
                        emit_homog, scale, omega, cover)

    @staticmethod
    @once_differentiable
    def backward(ctx, gr, gy, gh=None):
        tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm, homog_vm, omega = (
            ctx.saved_tensors)
        gr, gy = gr.contiguous(), gy.contiguous()
        if homog_vm is not None:
            dtgt, dpj, dh = rhs_moments_cached_bwd(gr, gy, tgt_vm, pj_cm, homog_vm, weights_pad,
                                                   sd_cm, omega=omega)
            return (None, dtgt, dpj, None, None, None, None, dh, None, None, None, None)
        dtgt, dpj, dfeat = rhs_moments_bwd(
            gr, gy, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm,
            gh=gh.contiguous() if ctx.emit_homog else None, omega=omega)
        return (None, dtgt, dpj, dfeat, None, None, None, None, None, None, None, None)


def _rhs_run(name, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm, homog_vm,
             emit_homog: bool, scale: bool, omega, cover):
    """One checked K2 form: its kernel on CUDA tensors, its twin on CPU ones."""
    cached = homog_vm is not None
    extra = {} if omega is None else dict(omega=omega)
    if not tgt_vm.is_cuda:
        if cached:
            return rhs_moments_cached_ref(tgt_vm, pj_cm, homog_vm, weights_pad, sd_cm, scale,
                                          **extra)
        args = (tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm)
        if emit_homog:
            return rhs_moments_h_ref(*args, **extra)
        return rhs_moments_ref(*args, scale=scale, **extra)
    _, J, B = pj_cm.shape
    Vp = weights_pad.shape[0]
    v_t = tgt_vm.shape[1]
    E = sd_cm.shape[2]
    F = 0 if cached else feat_cols.shape[0]
    lib = _build.library()
    dev = tgt_vm.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    per_block, n_splits = _segment_runs(cover.n_seg, B, dev, 1)
    r, y = empty(E, B), empty(3, J, B)
    homog = empty(3, Vp, B) if emit_homog else homog_vm
    rt, yt, sc = (empty(E, B), empty(3, J, B), empty(3, B)) if scale else (None,) * 3
    n_rows = 6 * J + 2 * E + 3 if scale else 3 * J + E
    part = empty(n_splits, n_rows, B)

    def ptr(t):
        return None if t is None else _ptr(t)

    err = lib.rhs_moments_launch(
        _ptr(tgt_vm), _ptr(pj_cm), ptr(feat_cols), _ptr(weights_pad), ptr(consts_pad),
        _ptr(sd_cm), ptr(omega), _ptr(cover.verts), _ptr(cover.seg_offset), _ptr(cover.joints),
        _ptr(cover.joint_offset), _ptr(r), _ptr(y), ptr(homog), ptr(rt), ptr(yt), ptr(sc),
        _ptr(part), J, B, F, E, v_t, Vp, cover.n_seg, per_block, cover.covers,
        int(emit_homog), int(scale), int(cached), _stream(r))
    _build.check(err, name)
    LAUNCHES[name] += 1
    if emit_homog:
        return r, y, homog
    return (r, y, rt, yt, sc) if scale else (r, y)


def rhs_moments_h(tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm, omega=None,
                  cover: BlendSegments | None = None):
    """Residual projection of the shape solve.

    With pos = the extended LBS of :func:`lbs_points` and b = tgt - pos (zero
    past the target's V rows): r (E, B) = sum_v sum_c SD_v[c, :] (Rbar_v^T b_v)_c,
    y (3, J, B) = sum_v w_vj b_v, and the posed template homog (3, V_pad, B).
    A static fit-weight column ``omega`` (V_pad, 1) multiplies b.

    ``cover`` (:func:`wgram_cover` of ``weights_pad``, the fitter's
    ``GramData.wgram_cover``) is the vertex cover the kernel walks; it must
    hold every target row, and where it stops short of V_pad the template's
    rows past it must be zero (so are homog's). None builds a cover of every
    row on the host (a copy from the card at every call). The twin ignores
    it; so do the forms below, which take it the same way."""
    return _rhs_call('rhs_moments_h', tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm,
                     None, emit_homog=True, scale=False, omega=omega, cover=cover)


def rhs_moments(tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm, scale: bool = False,
                omega=None, cover: BlendSegments | None = None):
    """:func:`rhs_moments_h` without the posed template: (r, y). With
    ``scale=True`` also the target-side moments of the scale column,
    rt (E, B) = sum_v sum_c SD_v[c, :] (Rbar_v^T t_v)_c, yt (3, J, B) =
    sum_v w_vj t_v and sc (3, B) = [sum |t|^2, sum t.pos, sum |pos|^2] over
    the target's rows: (r, y, rt, yt, sc). A static ``omega`` (V_pad, 1)
    weights every vertex sum."""
    return _rhs_call('rhs_moments_scale' if scale else 'rhs_moments', tgt_vm, pj_cm, feat_cols,
                     weights_pad, consts_pad, sd_cm, None, emit_homog=False, scale=scale,
                     omega=omega, cover=cover)


def rhs_moments_cached(tgt_vm, pj_cm, homog_vm, weights_pad, sd_cm, scale: bool = False,
                       omega=None, cover: BlendSegments | None = None):
    """:func:`rhs_moments` from the cached posed template ``homog_vm``
    (3, V_pad, B) of :func:`posed_template_lm` instead of feat and consts:
    the same outputs, (r, y) or with ``scale=True`` (r, y, rt, yt, sc)."""
    return _rhs_call('rhs_moments_cached_scale' if scale else 'rhs_moments_cached', tgt_vm,
                     pj_cm, None, weights_pad, None, sd_cm, homog_vm, emit_homog=False,
                     scale=scale, omega=omega, cover=cover)


# ---------------------------------------------------------------------------
# K11 and K12: backward of the residual moments (emit-homog / plain, cached)
# ---------------------------------------------------------------------------


def _rhs_bwd_twin(gr, gy, tgt_vm, pj_cm, homog, weights_pad, sd_cm, omega):
    """K2's VJP in plain PyTorch from the posed template homog (3, V_pad, B):
    (dtgt (3, V_t, B), dpj (12, J, B), dh (3, V_pad, B))."""
    v_t = tgt_vm.shape[1]
    Vp = weights_pad.shape[0]
    blend = torch.einsum('vj,xjb->xvb', weights_pad, pj_cm)
    pos = _apply_blend(blend, homog)
    om = torch.zeros((Vp, 1), dtype=pos.dtype, device=pos.device)
    om[:v_t] = 1.0 if omega is None else omega[:v_t]  # zero past the targets' rows
    t = torch.zeros_like(pos)
    t[:, :v_t] = tgt_vm
    b = (t - pos) * om
    G = torch.einsum('cve,eb->cvb', sd_cm, gr)
    db = (torch.einsum('vj,ajb->avb', weights_pad, gy)
          + torch.stack([sum(blend[a * 4 + c] * G[c] for c in range(3)) for a in range(3)])) * om
    dblend = torch.stack([-db[a] * homog[c] + G[c] * b[a] if c < 3 else -db[a]
                          for a in range(3) for c in range(4)])
    dpj = torch.einsum('vj,xvb->xjb', weights_pad, dblend)
    return db[:, :v_t].contiguous(), dpj.contiguous(), -_project_rbar(blend, db)


def rhs_moments_bwd_ref(gr, gy, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm,
                        gh=None, omega=None):
    """Plain twin of :func:`rhs_moments_bwd`."""
    homog = posed_template_ref(feat_cols, consts_pad)
    dtgt, dpj, dh = _rhs_bwd_twin(gr, gy, tgt_vm, pj_cm, homog, weights_pad, sd_cm, omega)
    if gh is not None:
        dh = dh + gh
    return dtgt, dpj, torch.einsum('cvf,cvb->fb', consts_pad[:3], dh).contiguous()


def rhs_moments_cached_bwd_ref(gr, gy, tgt_vm, pj_cm, homog_vm, weights_pad, sd_cm, omega=None):
    """Plain twin of :func:`rhs_moments_cached_bwd`."""
    dtgt, dpj, dh = _rhs_bwd_twin(gr, gy, tgt_vm, pj_cm, homog_vm, weights_pad, sd_cm, omega)
    return dtgt, dpj, dh.contiguous()


def rhs_moments_bwd(gr, gy, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm, gh=None,
                    omega=None):
    """The VJP of :func:`rhs_moments` and, with the cotangent ``gh``
    (3, V_pad, B) of the emitted template, of :func:`rhs_moments_h` (K11),
    for the cotangents gr (E, B) of r and gy (3, J, B) of y; a static
    ``omega`` (V_pad, 1) selects the weighted form. With G_c = SD_c gr and
    db_a = ω (sum_j w_vj gy[a, j] + sum_c blend_ac G_c): dtgt = db (3, V_t, B),
    dpj (12, J, B) = sum_v w_vj (-db_a h_c + G_c b_a) (c < 3; -db_a for c = 3,
    b the weighted residual) and dfeat (F, B) = sum_c consts_c^T dh_c with
    dh = -Rbar^T db [+ gh]. Returns (dtgt, dpj, dfeat)."""
    name = ('rhs_moments_bwd' if gh is None else 'rhs_moments_h_bwd') + (
        '' if omega is None else '_w')
    tensors = dict(gr=gr, gy=gy, tgt_vm=tgt_vm, pj_cm=pj_cm, feat_cols=feat_cols,
                   weights_pad=weights_pad, consts_pad=consts_pad, sd_cm=sd_cm)
    tensors.update({k: v for k, v in (('gh', gh), ('omega', omega)) if v is not None})
    cuda = _on_cuda(name, **tensors)
    J, B, E, Vp, v_t = _rhs_bwd_dims(name, gr, gy, tgt_vm, pj_cm, weights_pad, sd_cm, omega)
    F = feat_cols.shape[0]
    _expect(name, 'feat_cols', feat_cols, (F, B))
    _expect(name, 'consts_pad', consts_pad, (None, Vp, F))
    if gh is not None:
        _expect(name, 'gh', gh, (3, Vp, B))
    if not cuda:
        return rhs_moments_bwd_ref(gr, gy, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad,
                                   sd_cm, gh, omega)
    dev = gr.device
    dtgt = torch.empty((3, v_t, B), dtype=torch.float32, device=dev)
    out = _rhs_bwd_launch(name, gr, gy, gh, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad,
                          sd_cm, omega, None, dtgt, None, F)
    return dtgt, out[:12 * J].view(12, J, B), out[12 * J:]


def rhs_moments_cached_bwd(gr, gy, tgt_vm, pj_cm, homog_vm, weights_pad, sd_cm, omega=None):
    """The VJP of :func:`rhs_moments_cached` (K12): as :func:`rhs_moments_bwd`,
    with the per-vertex template cotangent dh = -Rbar^T db (3, V_pad, B)
    returned in place of dfeat (the posed template's backward folds it onto
    feat). Returns (dtgt, dpj, dh)."""
    name = 'rhs_moments_cached_bwd' + ('' if omega is None else '_w')
    extra = {} if omega is None else dict(omega=omega)
    cuda = _on_cuda(name, gr=gr, gy=gy, tgt_vm=tgt_vm, pj_cm=pj_cm, homog_vm=homog_vm,
                    weights_pad=weights_pad, sd_cm=sd_cm, **extra)
    J, B, E, Vp, v_t = _rhs_bwd_dims(name, gr, gy, tgt_vm, pj_cm, weights_pad, sd_cm, omega)
    _expect(name, 'homog_vm', homog_vm, (3, Vp, B))
    if not cuda:
        return rhs_moments_cached_bwd_ref(gr, gy, tgt_vm, pj_cm, homog_vm, weights_pad, sd_cm,
                                          omega)
    dev = gr.device
    dtgt = torch.empty((3, v_t, B), dtype=torch.float32, device=dev)
    dh = torch.empty((3, Vp, B), dtype=torch.float32, device=dev)
    out = _rhs_bwd_launch(name, gr, gy, None, tgt_vm, pj_cm, None, weights_pad, None, sd_cm,
                          omega, homog_vm, dtgt, dh, 0)
    return dtgt, out.view(12, J, B), dh


def _rhs_bwd_dims(name, gr, gy, tgt_vm, pj_cm, weights_pad, sd_cm, omega):
    """Shape checks shared by K11 and K12: (J, B, E, V_pad, V_t)."""
    _, J, B = pj_cm.shape
    Vp = weights_pad.shape[0]
    v_t = tgt_vm.shape[1]
    E = sd_cm.shape[2]
    _expect(name, 'gr', gr, (E, B))
    _expect(name, 'gy', gy, (3, J, B))
    _expect(name, 'tgt_vm', tgt_vm, (3, v_t, B))
    _expect(name, 'weights_pad', weights_pad, (Vp, J))
    _expect(name, 'sd_cm', sd_cm, (3, Vp, E))
    if v_t > Vp:
        raise ValueError(f'{name}: target rows {v_t} exceed V_pad {Vp}')
    if omega is not None:
        _omega_strides(name, omega, v_t, B, Vp, static_only=True)
    if gr.is_cuda and (J > _BWD_MAXJ or E > 32):
        raise ValueError(f'{name}: the kernel takes J <= {_BWD_MAXJ} and E <= 32, got {J}, {E}')
    return J, B, E, Vp, v_t


def _rhs_bwd_launch(name, gr, gy, gh, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, sd_cm,
                    omega, homog_vm, dtgt, dh, F):
    """Launch K11 (``homog_vm`` None) or K12 into ``dtgt`` (and ``dh``);
    returns the per-column outputs (12 J [+ F], B)."""
    _, J, B = pj_cm.shape
    Vp = weights_pad.shape[0]
    E = sd_cm.shape[2]
    dev = gr.device
    tiles_per_block, n_splits = _vertex_splits(Vp, B, dev)
    out = torch.empty((12 * J + F, B), dtype=torch.float32, device=dev)
    part = torch.empty((n_splits, 12 * J + F, B), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else _ptr(t)

    err = _build.library().rhs_bwd_launch(
        _ptr(gr), _ptr(gy), ptr(gh), _ptr(tgt_vm), _ptr(pj_cm), ptr(feat_cols), _ptr(weights_pad),
        ptr(consts_pad), _ptr(sd_cm), ptr(omega), ptr(homog_vm), _ptr(dtgt), ptr(dh), _ptr(out),
        _ptr(part), J, B, F, E, tgt_vm.shape[1], Vp, tiles_per_block, int(homog_vm is not None),
        _stream(out))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return out


# ---------------------------------------------------------------------------
# K3: per-instance Gramian assembly
# ---------------------------------------------------------------------------


def gram_assembly_ref(R_cm, T_cm, y_cm, P_cm, bJ_cm, ksd, lz, sd1_2d, q, w1,
                      has_joints: bool = False):
    """Plain twin of :func:`gram_assembly` (``gram_assembly_ref`` of the JAX package)."""
    _, J3, B = R_cm.shape
    E = sd1_2d.shape[1]
    X = torch.einsum('ajb,akb->jkb', R_cm, R_cm).reshape(J3 * J3, B)
    G = ksd.T @ X  # (E*E, B)
    T3 = T_cm.reshape(3, E, -1, B)
    Z3 = torch.einsum('jx,ajb->axb', lz, R_cm).reshape(3, E, -1, B)
    M1 = torch.einsum('aejb,afjb->efb', Z3, T3)
    Q3 = torch.einsum('jk,aekb->aejb', q, T3)
    M2 = torch.einsum('aejb,afjb->efb', Q3, T3)
    G = G + (M1 + M1.transpose(0, 1) + M2).reshape(E * E, B)
    SA = torch.einsum('je,ajb->aeb', sd1_2d, R_cm) + torch.einsum('j,aejb->aeb', w1[:, 0], T3)
    rb = torch.einsum('aejb,ajb->eb', T3, y_cm)
    Sb = y_cm.sum(dim=1)
    if has_joints:
        P3 = P_cm.reshape(3, E, -1, B)
        G = G + torch.einsum('aejb,afjb->efb', P3, P3).reshape(E * E, B)
        SA = SA + P3.sum(dim=2)
        rb = rb + torch.einsum('aejb,ajb->eb', P3, bJ_cm)
        Sb = Sb + bJ_cm.sum(dim=1)
    return G.contiguous(), SA.reshape(3 * E, B).contiguous(), rb.contiguous(), Sb.contiguous()


def gram_assembly(R_cm, T_cm, y_cm, P_cm, bJ_cm, ksd, lz, sd1_2d, q, w1,
                  has_joints: bool = False):
    """Per-instance Gramian of the shape solve (see :func:`gram_assembly_ref`).

    R_cm (3, 3J, B) rotations, rows (j, c); T_cm (3, E*J, B) joint translation
    Jacobian columns, rows (e, j); y_cm (3, J, B) from :func:`rhs_moments_h`;
    P_cm (3, E*J, B), bJ_cm (3, J, B) the joints block (any (3, 1, B) dummies
    when ``has_joints`` is False); ksd (9J^2, E^2), lz (3J, E*J),
    sd1_2d (3J, E), q (J, J), w1 (J, 1) static moments.
    Returns G (E^2, B), SA (3E, B), rb (E, B), Sb (3, B).

    Runs the fused kernel K3 (E <= 16), or where :func:`streams_term1` says
    so (large J) the streamed term1 kernel K8 plus :func:`gram_mparts_ref`
    in tensor ops."""
    name = 'gram_assembly'
    cuda =_on_cuda(name, R_cm=R_cm, T_cm=T_cm, y_cm=y_cm, P_cm=P_cm, bJ_cm=bJ_cm, ksd=ksd,
                    lz=lz, sd1_2d=sd1_2d, q=q, w1=w1)
    _, J3, B = R_cm.shape
    J = J3 // 3
    E = sd1_2d.shape[1]
    _expect(name, 'R_cm', R_cm, (3, 3 * J, B))
    _expect(name, 'T_cm', T_cm, (3, E * J, B))
    _expect(name, 'y_cm', y_cm, (3, J, B))
    if has_joints:
        _expect(name, 'P_cm', P_cm, (3, E * J, B))
        _expect(name, 'bJ_cm', bJ_cm, (3, J, B))
    _expect(name, 'ksd', ksd, (J3 * J3, E * E))
    _expect(name, 'lz', lz, (J3, E * J))
    _expect(name, 'sd1_2d', sd1_2d, (J3, E))
    _expect(name, 'q', q, (J, J))
    _expect(name, 'w1', w1, (J, 1))
    if streams_term1(J3, E):
        G2, SA, rb, Sb = gram_mparts_ref(R_cm, T_cm, y_cm, P_cm, bJ_cm, lz, sd1_2d, q, w1,
                                         has_joints)
        return (term1(R_cm, ksd) + G2).contiguous(), SA, rb, Sb
    if cuda and E > 16:
        raise ValueError(f'{name}: the kernel takes E <= 16, got {E}')
    args = (R_cm, T_cm, y_cm, P_cm, bJ_cm, ksd, lz, sd1_2d, q, w1, has_joints)
    if _twin_for_constant_grads(name, cuda, ksd, lz, sd1_2d, q, w1):
        return gram_assembly_ref(*args)
    return _GramAssembly.apply(*args)


class _GramAssembly(torch.autograd.Function):
    """K3; its backward is the VJP of :func:`gram_assembly_ref`, recomputed
    under autograd (the JAX package's _gram_assembly_bwd is that XLA VJP)."""

    @staticmethod
    def forward(ctx, R_cm, T_cm, y_cm, P_cm, bJ_cm, ksd, lz, sd1_2d, q, w1, has_joints):
        ctx.has_joints = has_joints
        ctx.save_for_backward(R_cm, T_cm, y_cm, P_cm, bJ_cm, ksd, lz, sd1_2d, q, w1)
        if not R_cm.is_cuda:
            return gram_assembly_ref(R_cm, T_cm, y_cm, P_cm, bJ_cm, ksd, lz, sd1_2d, q, w1,
                                     has_joints)
        _, J3, B = R_cm.shape
        E = sd1_2d.shape[1]
        dev = R_cm.device
        G = torch.empty((E * E, B), dtype=torch.float32, device=dev)
        SA = torch.empty((3 * E, B), dtype=torch.float32, device=dev)
        rb = torch.empty((E, B), dtype=torch.float32, device=dev)
        Sb = torch.empty((3, B), dtype=torch.float32, device=dev)
        err = _build.library().gram_assembly_launch(
            _ptr(R_cm), _ptr(T_cm), _ptr(y_cm), _ptr(P_cm), _ptr(bJ_cm), _ptr(ksd), _ptr(lz),
            _ptr(sd1_2d), _ptr(q), _ptr(w1), _ptr(G), _ptr(SA), _ptr(rb), _ptr(Sb),
            J3 // 3, E, B, int(has_joints), _stream(G))
        _build.check(err, 'gram_assembly')
        LAUNCHES['gram_assembly'] += 1
        return G, SA, rb, Sb

    @staticmethod
    @once_differentiable
    def backward(ctx, gG, gSA, grb, gSb):
        TORCH_VJPS['gram_assembly'] += 1
        saved = ctx.saved_tensors
        with torch.enable_grad():
            xs = [t.detach().requires_grad_() for t in saved[:5]]
            outs = gram_assembly_ref(*xs, *saved[5:], has_joints=ctx.has_joints)
            grads = torch.autograd.grad(outs, xs, (gG, gSA, grb, gSb), allow_unused=True)
        return grads + (None,) * 6


def streams_term1(J3: int, E: int) -> bool:
    """True where the Gramian takes the streamed route (K8 + the small parts
    in tensor ops): the J3^2 E^2 4 bytes of Ksd exceed TERM1_STREAM_MIN_BYTES."""
    return J3 * J3 * E * E * 4 > TERM1_STREAM_MIN_BYTES


def gram_mparts_ref(R_cm, T_cm, y_cm, P_cm, bJ_cm, lz, sd1_2d, q, w1, has_joints: bool):
    """Every piece of :func:`gram_assembly` except term1 (Ksd : X), in tensor
    ops, as ``_gram_mparts_ref`` of the JAX package states them in XLA:
    (G - term1, SA, rb, Sb). All are (B, ~E J) contractions, cheap at any J."""
    _, J3, B = R_cm.shape
    E = sd1_2d.shape[1]
    T3 = T_cm.reshape(3, E, -1, B)
    Z3 = torch.einsum('jx,ajb->axb', lz, R_cm).reshape(3, E, -1, B)
    M1 = torch.einsum('aejb,afjb->efb', Z3, T3)
    Q3 = torch.einsum('jk,aekb->aejb', q, T3)
    M2 = torch.einsum('aejb,afjb->efb', Q3, T3)
    G = (M1 + M1.transpose(0, 1) + M2).reshape(E * E, B)
    SA = torch.einsum('je,ajb->aeb', sd1_2d, R_cm) + torch.einsum('j,aejb->aeb', w1[:, 0], T3)
    rb = torch.einsum('aejb,ajb->eb', T3, y_cm)
    Sb = y_cm.sum(dim=1)
    if has_joints:
        P3 = P_cm.reshape(3, E, -1, B)
        G = G + torch.einsum('aejb,afjb->efb', P3, P3).reshape(E * E, B)
        SA = SA + P3.sum(dim=2)
        rb = rb + torch.einsum('aejb,ajb->eb', P3, bJ_cm)
        Sb = Sb + bJ_cm.sum(dim=1)
    return G, SA.reshape(3 * E, B).contiguous(), rb.contiguous(), Sb.contiguous()


# ---------------------------------------------------------------------------
# K8: streamed term1 of the large-J Gramian
# ---------------------------------------------------------------------------


def term1_ref(R_cm, ksd):
    """Plain twin of :func:`term1`: X materialized, then one product."""
    _, J3, B = R_cm.shape
    X = torch.einsum('ajb,akb->jkb', R_cm, R_cm).reshape(J3 * J3, B)
    return (ksd.T @ X).contiguous()


def term1(R_cm, ksd):
    """term1 of the Gramian, G1 (E^2, B) = Ksd^T X with X[(j,k)] =
    sum_a R_a[j] R_a[k], for rotations R_cm (3, J3, B) (rows (joint, c)) and
    Ksd (J3^2, E^2), without forming X. E <= 32."""
    name = 'term1'
    cuda = _on_cuda(name, R_cm=R_cm, ksd=ksd)
    _, J3, B = R_cm.shape
    EE = ksd.shape[1]
    _expect(name, 'R_cm', R_cm, (3, J3, B))
    _expect(name, 'ksd', ksd, (J3 * J3, EE))
    if cuda and EE > 32 * 32:
        raise ValueError(f'{name}: the kernel takes E <= 32, got E^2 = {EE}')
    if _twin_for_constant_grads(name, cuda, ksd):
        return term1_ref(R_cm, ksd)
    return _Term1.apply(R_cm, ksd)


def term1_splits(J3: int, EE: int, B: int, device) -> int:
    """Splits of K8's J3^2 sum: as many as fill one wave of the card (one
    resident block per SM) with the grid's (row, batch) tiles, at most one per
    k stage of 8 k by 5 j values (4 at SMPL-X b4096 on 132 SMs)."""
    tiles = -(-EE // _TERM1_TILE[0]) * -(-B // _TERM1_TILE[1])
    stages = -(-J3 // _TERM1_KB) * -(-J3 // _TERM1_JS)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(stages, sms // tiles))


class _Term1(torch.autograd.Function):
    """K8; its backward in PyTorch ops (the JAX package folds term1 into the
    XLA VJP of the Gramian): dX = Ksd g, formed once, batch-major as
    (B, J3, J3), then dR_a[j] = sum_k (dX[j, k] + dX[k, j]) R_a[k] as two
    batched products."""

    @staticmethod
    def forward(ctx, R_cm, ksd):
        ctx.save_for_backward(R_cm, ksd)
        if not R_cm.is_cuda:
            return term1_ref(R_cm, ksd)
        _, J3, B = R_cm.shape
        EE = ksd.shape[1]
        G = torch.empty((EE, B), dtype=torch.float32, device=R_cm.device)
        S = term1_splits(J3, EE, B, R_cm.device)
        part = torch.empty((S, EE, B), dtype=torch.float32, device=R_cm.device) if S > 1 else None
        err = _build.library().term1_launch(_ptr(R_cm), _ptr(ksd),
                                            None if part is None else _ptr(part), _ptr(G),
                                            J3, EE, B, S, _stream(G))
        _build.check(err, 'term1')
        LAUNCHES['term1'] += 1
        return G

    @staticmethod
    @once_differentiable
    def backward(ctx, gG):
        TORCH_VJPS['term1'] += 1
        R_cm, ksd = ctx.saved_tensors
        _, J3, B = R_cm.shape
        dX = (gG.T @ ksd.T).view(B, J3, J3)
        Rb = R_cm.permute(2, 1, 0)  # (B, J3, 3)
        dR = torch.bmm(dX, Rb) + torch.bmm(dX.transpose(1, 2), Rb)
        return dR.permute(2, 1, 0).contiguous(), None


# ---------------------------------------------------------------------------
# K4: cached reconstruction fused into per-part sums
# ---------------------------------------------------------------------------


def _active_joints(weights, verts: np.ndarray, seg_offset: np.ndarray, J: int):
    """Each segment's active joints, ascending: every joint with a nonzero
    weight in ``weights`` (V, J) on any of the segment's vertices (every
    joint for ``weights`` None). Returns (joints, joint_offset, longest)."""
    joints, joint_offset = [], [0]
    for s0, s1 in zip(seg_offset[:-1], seg_offset[1:]):
        if weights is None:
            js = np.arange(J)
        else:
            js = np.nonzero(np.any(weights[verts[s0:s1]] != 0, axis=0))[0]
        joints.extend(js)
        joint_offset.append(len(joints))
    counts = np.diff(joint_offset)
    return joints, joint_offset, int(counts.max()) if len(counts) else 0


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.int32), device=device)


@dataclass(eq=False)
class BlendSegments:
    """Vertex segments with the joints that skin them: the cover that K9
    walks. ``verts`` lists vertices segment after segment (``seg_offset``
    (n_seg + 1) bounds each), ``joints`` each segment's active joints
    (``joint_offset`` (n_seg + 1)), ascending: every joint with a nonzero
    skinning weight on any of the segment's vertices, ``max_joints`` the
    longest list. Every vertex below ``covers`` appears exactly once. A
    blend over a segment's list is exact: the joints left out weigh 0 on all
    of its vertices. Built once per model on the host
    (:func:`wgram_cover`); K1, K2 and K9 walk it."""

    verts: torch.Tensor
    seg_offset: torch.Tensor
    joints: torch.Tensor
    joint_offset: torch.Tensor
    max_joints: int
    covers: int
    # (operand, storage, version) of the operands found zero past `covers`
    zero_past: set = field(default_factory=set, repr=False)

    @property
    def n_seg(self) -> int:
        return self.seg_offset.shape[0] - 1


def wgram_cover(weights: np.ndarray, num_vertices: int, device) -> BlendSegments:
    """K9's cover of the vertices below ``num_vertices``: grouped by body part
    (each vertex's dominant joint, in canonical order within a part) and cut
    into segments of at most 32 vertices (one tile of csrc/wgram.cu), with
    each segment's active joints of the skinning ``weights`` (>= V, J)."""
    w = np.asarray(weights)[:num_vertices]
    J = w.shape[1]
    dominant = np.argmax(w, axis=1)
    verts, seg_offset = [], [0]
    for j in range(J):
        vs = np.nonzero(dominant == j)[0]
        for s in range(0, len(vs), _WGRAM_SEG):
            verts.extend(vs[s:s + _WGRAM_SEG])
            seg_offset.append(len(verts))
    verts = np.asarray(verts, np.int64)
    joints, joint_offset, longest = _active_joints(w, verts, np.asarray(seg_offset), J)
    return BlendSegments(verts=_i32(verts, device), seg_offset=_i32(seg_offset, device),
                         joints=_i32(joints, device), joint_offset=_i32(joint_offset, device),
                         max_joints=longest, covers=int(num_vertices))


@dataclass
class PartIndex:
    """One-hot body-part membership of the vertices, in two forms built from
    the same matrix: ``pm`` (J, V_pad) for the plain twin, and the per-part
    vertex lists cut into segments of at most 512 for the kernel
    (``verts``: used vertices grouped by part; ``seg_offset`` (n_seg + 1):
    segment bounds in ``verts``; ``part_seg`` (J + 1): each part's segments),
    for the backward kernels each vertex's part (``vpart`` (V_pad,), -1 for
    none), and each segment's active joints for K6's blend (``joints``,
    ``joint_offset`` (n_seg + 1), as :class:`BlendSegments`'): those of the
    skinning weights the index was built with, every joint without them.
    K6 and K14 blend over these lists only, so they must come from the same
    weights as their ``weights_pad``. K14 walks the segments in tiles of at
    most 32 vertices (``tile_offset`` (n_tiles + 1): tile bounds in
    ``verts``; ``tile_seg`` (n_tiles): each tile's segment) and zeroes the
    rows of ``unused``, the vertices below V_pad in no part."""

    pm: torch.Tensor
    verts: torch.Tensor
    seg_offset: torch.Tensor
    part_seg: torch.Tensor
    vpart: torch.Tensor
    joints: torch.Tensor
    joint_offset: torch.Tensor
    tile_offset: torch.Tensor
    tile_seg: torch.Tensor
    unused: torch.Tensor

    @property
    def n_seg(self) -> int:
        return self.seg_offset.shape[0] - 1

    @property
    def n_tiles(self) -> int:
        return self.tile_offset.shape[0] - 1

    @classmethod
    def from_membership(cls, pm: np.ndarray, device, weights=None) -> 'PartIndex':
        """The index of membership ``pm`` (J, V_pad); ``weights`` (>= V, J)
        the skinning weights whose active joints K6 blends over (None:
        every joint)."""
        pm = np.asarray(pm, np.float32)
        if not np.all((pm == 0) | (pm == 1)) or np.any(pm.sum(axis=0) > 1):
            raise ValueError('part membership must be one-hot 0/1 over vertices')
        verts, seg_offset, part_seg = [], [0], [0]
        for j in range(pm.shape[0]):
            vs = np.nonzero(pm[j])[0]
            for s in range(0, len(vs), _SEG):
                verts.extend(vs[s:s + _SEG])
                seg_offset.append(len(verts))
            part_seg.append(len(seg_offset) - 1)
        verts = np.asarray(verts, np.int64)
        w = None if weights is None else np.asarray(weights)
        joints, joint_offset, _ = _active_joints(w, verts, np.asarray(seg_offset), pm.shape[0])
        vpart = np.where(pm.any(axis=0), pm.argmax(axis=0), -1)
        tiles = [(b, s) for s in range(len(seg_offset) - 1)
                 for b in range(seg_offset[s], seg_offset[s + 1], _PART_TILE)]
        return cls(pm=torch.as_tensor(pm, device=device), verts=_i32(verts, device),
                   seg_offset=_i32(seg_offset, device), part_seg=_i32(part_seg, device),
                   vpart=_i32(vpart, device), joints=_i32(joints, device),
                   joint_offset=_i32(joint_offset, device),
                   tile_offset=_i32([b for b, _ in tiles] + [len(verts)], device),
                   tile_seg=_i32([s for _, s in tiles], device),
                   unused=_i32(np.nonzero(vpart < 0)[0], device))


def recon_part_sums_cached_ref(tgt_vm, pj_cm, x_cols, sd_cm, homog_vm, pm, weights_pad,
                               omega=None):
    """Plain twin of :func:`recon_part_sums_cached_lm` (``pm``: (J, V_pad))."""
    hfull = homog_vm + torch.einsum('cve,eb->cvb', sd_cm, x_cols)
    blend = torch.einsum('vj,xjb->xvb', weights_pad, pj_cm)
    return _part_sums_of(pm, tgt_vm, _apply_blend(blend, hfull), omega)


def _omega_args(name, omega, v_t, B, Vp):
    """The kernel's fit-weight arguments (pointer, rows, row and batch
    strides), all zero without weights."""
    if omega is None:
        return None, 0, 0, 0
    rows, rs, bs = _omega_strides(name, omega, v_t, B, Vp)
    return _ptr(omega), rows, rs, bs


def recon_part_sums_cached_lm(tgt_vm, pj_cm, x_cols, sd_cm, homog_vm, parts: PartIndex,
                              weights_pad, omega=None):
    """Per-part sums against the shape solve's reconstruction, rebuilt from
    the cached posed template: hfull = homog + SD x, pos = blended [R|t] hfull;
    raw (9, J, B) = sum_v pm_jv t_c pos_d (rows c*3+d), s_t (3, J, B) =
    sum_v pm_jv t, s_a (3, J, B) = sum_v pm_jv pos. Fit weights ``omega``,
    static (V_pad, 1) or per call (V_t, B), multiply pos in every sum and t
    in s_t."""
    name = 'recon_part_sums_cached' + ('' if omega is None else '_w')
    extra = {} if omega is None else dict(omega=omega)
    cuda = _on_cuda(name, tgt_vm=tgt_vm, pj_cm=pj_cm, x_cols=x_cols, sd_cm=sd_cm,
                    homog_vm=homog_vm, pm=parts.pm, weights_pad=weights_pad, **extra)
    _, J, B = pj_cm.shape
    Vp = weights_pad.shape[0]
    v_t = tgt_vm.shape[1]
    E = x_cols.shape[0]
    _expect(name, 'tgt_vm', tgt_vm, (3, v_t, B))
    _expect(name, 'pj_cm', pj_cm, (12, J, B))
    _expect(name, 'x_cols', x_cols, (E, B))
    _expect(name, 'sd_cm', sd_cm, (3, Vp, E))
    _expect(name, 'homog_vm', homog_vm, (3, Vp, B))
    _expect(name, 'pm', parts.pm, (J, Vp))
    _expect(name, 'weights_pad', weights_pad, (Vp, J))
    if v_t > Vp:
        raise ValueError(f'{name}: target rows {v_t} exceed V_pad {Vp}')
    _omega_args(name, omega, v_t, B, Vp)
    if cuda and E > 32:
        raise ValueError(f'{name}: the kernel takes E <= 32, got {E}')
    args = (name, tgt_vm, pj_cm, x_cols, sd_cm, homog_vm, parts, weights_pad, omega)
    call_omega = omega is not None and omega.shape != (Vp, 1)
    if _twin_for_constant_grads(name, cuda, sd_cm, parts.pm, weights_pad,
                                None if call_omega else omega):
        return _recon_cached_run(*args)
    if call_omega:  # no backward kernel: the VJP of the twin in torch ops
        return _recon_cached_call_vjp(*args)
    return _ReconCached.apply(*args)


def _recon_cached_call_vjp(name, tgt_vm, pj_cm, x_cols, sd_cm, homog_vm, parts, weights_pad,
                           omega):
    """K4 under per-call ω as a _ChunkedVjp: tgt, pj, x, the cached template
    and ω differentiate."""
    def run(tgt, pj, x, sd, homog, pm, w, om):
        return _recon_cached_run(name, tgt, pj, x, sd, homog, parts, w, om)

    return _ChunkedVjp.apply('recon_part_sums_cached_call_w', run, recon_part_sums_cached_ref,
                             tgt_vm.shape[1], (1, None, None, 1, 1, 1, 0, 0), (0, 1, 2, 4, 7),
                             tgt_vm, pj_cm, x_cols, sd_cm, homog_vm, parts.pm, weights_pad, omega)


def _recon_cached_run(name, tgt_vm, pj_cm, x_cols, sd_cm, homog_vm, parts, weights_pad, omega):
    """Checked K4: its kernel on CUDA tensors, its twin on CPU ones."""
    if not tgt_vm.is_cuda:
        extra = {} if omega is None else dict(omega=omega)
        return recon_part_sums_cached_ref(tgt_vm, pj_cm, x_cols, sd_cm, homog_vm, parts.pm,
                                          weights_pad, **extra)
    _, J, B = pj_cm.shape
    Vp = weights_pad.shape[0]
    v_t = tgt_vm.shape[1]
    E = x_cols.shape[0]
    om_ptr, om_rows, om_rs, om_bs = _omega_args(name, omega, v_t, B, Vp)
    raw, s_t, s_a, part = _part_sums_outputs(name, parts, J, B, tgt_vm.device)
    err = _build.library().recon_part_sums_launch(
        _ptr(tgt_vm), _ptr(pj_cm), _ptr(x_cols), _ptr(sd_cm), _ptr(homog_vm),
        _ptr(weights_pad), om_ptr, _ptr(parts.verts), _ptr(parts.seg_offset),
        _ptr(parts.part_seg), _ptr(raw), _ptr(s_t), _ptr(s_a), _ptr(part), J, E, B, v_t, Vp,
        parts.n_seg, om_rows, om_rs, om_bs, _stream(raw))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return raw, s_t, s_a


class _ReconCached(torch.autograd.Function):
    """K4 (unweighted or static ω) with K13 as its backward: the JAX
    package's _recon_cached_diff and _recon_cached_w_diff."""

    @staticmethod
    def forward(ctx, name, tgt_vm, pj_cm, x_cols, sd_cm, homog_vm, parts, weights_pad, omega):
        ctx.parts = parts
        ctx.save_for_backward(tgt_vm, pj_cm, x_cols, sd_cm, homog_vm, weights_pad, omega)
        return _recon_cached_run(name, tgt_vm, pj_cm, x_cols, sd_cm, homog_vm, parts,
                                 weights_pad, omega)

    @staticmethod
    @once_differentiable
    def backward(ctx, graw, gst, gsa):
        tgt_vm, pj_cm, x_cols, sd_cm, homog_vm, weights_pad, omega = ctx.saved_tensors
        dtgt, dpj, dx, dh = recon_part_sums_cached_bwd(
            graw.contiguous(), gst.contiguous(), gsa.contiguous(), tgt_vm, pj_cm, x_cols, sd_cm,
            homog_vm, ctx.parts, weights_pad, omega=omega)
        return None, dtgt, dpj, dx, None, dh, None, None, None


# ---------------------------------------------------------------------------
# K13: backward of the cached reconstruction's part sums
# ---------------------------------------------------------------------------


def recon_part_sums_cached_bwd_ref(graw, gst, gsa, tgt_vm, pj_cm, x_cols, sd_cm, homog_vm, pm,
                                   weights_pad, omega=None):
    """Plain twin of :func:`recon_part_sums_cached_bwd` (``pm``: (J, V_pad))."""
    v_t = tgt_vm.shape[1]
    Vp = weights_pad.shape[0]
    hfull = homog_vm + torch.einsum('cve,eb->cvb', sd_cm, x_cols)
    blend = torch.einsum('vj,xjb->xvb', weights_pad, pj_cm)
    pos = _apply_blend(blend, hfull)
    om = torch.ones((Vp, 1), dtype=pos.dtype, device=pos.device)
    if omega is not None:
        om = torch.zeros_like(om)
        om[:v_t] = omega[:v_t]
    t = torch.zeros_like(pos)
    t[:, :v_t] = tgt_vm
    W = torch.einsum('jv,xjb->xvb', pm, graw)  # each vertex's part row
    dtgt = (torch.einsum('jv,cjb->cvb', pm, gst)
            + torch.stack([sum(W[c * 3 + d] * pos[d] for d in range(3)) for c in range(3)])) * om
    dpos = (torch.einsum('jv,djb->dvb', pm, gsa)
            + torch.stack([sum(W[c * 3 + d] * t[c] for c in range(3)) for d in range(3)])) * om
    dh = _project_rbar(blend, dpos)
    dx = torch.einsum('cve,cvb->eb', sd_cm, dh)
    dblend = torch.stack([dpos[a] * hfull[c] if c < 3 else dpos[a]
                          for a in range(3) for c in range(4)])
    dpj = torch.einsum('vj,xvb->xjb', weights_pad, dblend)
    return dtgt[:, :v_t].contiguous(), dpj.contiguous(), dx.contiguous(), dh.contiguous()


def recon_part_sums_cached_bwd(graw, gst, gsa, tgt_vm, pj_cm, x_cols, sd_cm, homog_vm,
                               parts: PartIndex, weights_pad, omega=None):
    """The VJP of :func:`recon_part_sums_cached_lm` (unweighted or a static
    ``omega`` (V_pad, 1)) for the cotangents graw (9, J, B), gst and gsa
    (3, J, B): with W = graw at the vertex's own part, dtgt_c = ω (gst + sum_d
    W[c*3+d] pos_d) (3, V_t, B), dpos_d = ω (gsa + sum_c W[c*3+d] t_c), the
    template cotangent dh = Rbar^T dpos (3, V_pad, B), dx (E, B) = sum_c
    SD_c^T dh_c and dpj (12, J, B) = sum_v w_vj dpos_a hfull_c (hfull_3 = 1).
    Returns (dtgt, dpj, dx, dh)."""
    name = 'recon_part_sums_cached_bwd' + ('' if omega is None else '_w')
    extra = {} if omega is None else dict(omega=omega)
    cuda = _on_cuda(name, graw=graw, gst=gst, gsa=gsa, tgt_vm=tgt_vm, pj_cm=pj_cm, x_cols=x_cols,
                    sd_cm=sd_cm, homog_vm=homog_vm, pm=parts.pm, weights_pad=weights_pad,
                    **extra)
    _, J, B = pj_cm.shape
    Vp = weights_pad.shape[0]
    v_t = tgt_vm.shape[1]
    E = x_cols.shape[0]
    _expect(name, 'graw', graw, (9, J, B))
    _expect(name, 'gst', gst, (3, J, B))
    _expect(name, 'gsa', gsa, (3, J, B))
    _expect(name, 'tgt_vm', tgt_vm, (3, v_t, B))
    _expect(name, 'x_cols', x_cols, (E, B))
    _expect(name, 'sd_cm', sd_cm, (3, Vp, E))
    _expect(name, 'homog_vm', homog_vm, (3, Vp, B))
    _expect(name, 'pm', parts.pm, (J, Vp))
    _expect(name, 'weights_pad', weights_pad, (Vp, J))
    if omega is not None:
        _omega_strides(name, omega, v_t, B, Vp, static_only=True)
    if not cuda:
        return recon_part_sums_cached_bwd_ref(graw, gst, gsa, tgt_vm, pj_cm, x_cols, sd_cm,
                                              homog_vm, parts.pm, weights_pad, **extra)
    if J > _BWD_MAXJ or E > 32:
        raise ValueError(f'{name}: the kernel takes J <= {_BWD_MAXJ} and E <= 32, got {J}, {E}')
    vp = _vpart(name, parts, Vp, graw.device)
    dev = graw.device
    tiles_per_block, n_splits = _vertex_splits(Vp, B, dev)
    dtgt = torch.empty((3, v_t, B), dtype=torch.float32, device=dev)
    dh = torch.empty((3, Vp, B), dtype=torch.float32, device=dev)
    out = torch.empty((12 * J + E, B), dtype=torch.float32, device=dev)
    part = torch.empty((n_splits, 12 * J + E, B), dtype=torch.float32, device=dev)
    err = _build.library().recon_bwd_launch(
        _ptr(graw), _ptr(gst), _ptr(gsa), _ptr(tgt_vm), _ptr(pj_cm), _ptr(x_cols), _ptr(sd_cm),
        _ptr(homog_vm), _ptr(weights_pad), None if omega is None else _ptr(omega), _ptr(vp),
        _ptr(dtgt), _ptr(dh), _ptr(out), _ptr(part), J, E, B, v_t, Vp, tiles_per_block,
        _stream(out))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return dtgt, out[:12 * J].view(12, J, B), out[12 * J:], dh


def _part_sums_outputs(name: str, parts: PartIndex, J: int, B: int, device):
    """Check the part index for a segment kernel; allocate raw (9, J, B),
    s_t and s_a (3, J, B) and the (n_seg, 15, B) segment partials."""
    for arg in ('verts', 'seg_offset', 'part_seg'):
        t = getattr(parts, arg)
        if t.dtype != torch.int32 or t.device != device or not t.is_contiguous():
            raise ValueError(f'{name}: parts.{arg} must be contiguous int32 on {device}')
    if parts.part_seg.shape[0] != J + 1:
        raise ValueError(f'{name}: parts.part_seg must have J + 1 = {J + 1} entries')

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=device)

    return empty(9, J, B), empty(3, J, B), empty(3, J, B), empty(max(parts.n_seg, 1), 15, B)


def _part_sums_of(pm, t, a, omega=None):
    """raw (9, J, B), s_t, s_a (3, J, B) of a target t (3, V_t, B) and a
    reference a (3, V_a, B|1) over the membership pm (J, >= max(V_t, V_a)).
    Fit weights ``omega`` ((V_pad, 1) or (V_t, B)) multiply a in every sum and
    t in s_t; rows past the target's are then left out of all three. s_a is
    (3, J, 1) for a batch-constant reference unless the weights vary over
    the batch."""
    if omega is None:
        v = min(t.shape[1], a.shape[1])
        pm_ta = pm[:, :v]
        raw = torch.stack([pm_ta @ (t[c, :v] * a[d, :v]) for c in range(3) for d in range(3)])
        s_t = torch.stack([pm[:, :t.shape[1]] @ t[c] for c in range(3)])
        s_a = torch.stack([pm[:, :a.shape[1]] @ a[d] for d in range(3)])
        return raw, s_t, s_a
    v = min(t.shape[1], a.shape[1])
    om = _omega_rows(omega, t.shape[1])
    pm_v = pm[:, :v]
    aw = [a[d, :v] * om[:v] for d in range(3)]
    raw = torch.stack([pm_v @ (t[c, :v] * aw[d]) for c in range(3) for d in range(3)])
    s_t = torch.stack([pm[:, :t.shape[1]] @ (t[c] * om) for c in range(3)])
    s_a = torch.stack([pm_v @ aw[d] for d in range(3)])
    return raw, s_t, s_a


# ---------------------------------------------------------------------------
# K5: per-part sums against a per-instance reference mesh
# ---------------------------------------------------------------------------


def part_sums_ref(t_vm, a_vm, pm, omega=None):
    """Plain twin of :func:`part_sums_vm_lm` (``pm``: (J, V_pad))."""
    return _part_sums_of(pm, t_vm, a_vm, omega)


def part_sums_vm_lm(t_vm, a_vm, parts: PartIndex, omega=None):
    """Per-part sums of a target t (3, V_t, B) against a reference a
    (3, V_a, B) that varies over the batch, or (3, V_a, 1) that does not:
    raw (9, J, B) = sum_v pm_jv t_c a_d (rows c*3+d), s_t (3, J, B) =
    sum_v pm_jv t, s_a (3, J, B|1) = sum_v pm_jv a.

    Fit weights ``omega``, static (V_pad, 1) or per call (V_t, B), multiply a
    in every sum and t in s_t; per-call weights make s_a (3, J, B). The fit
    sends a batch-constant reference without per-call weights to one GEMM
    (``models/bodyfitter.py:_part_sums_static_ref_lm``).

    Gradients: unweighted or with static ω, K15 (:func:`part_sums_bwd`); with
    per-call ω, torch ops (:class:`_ChunkedVjp`), which also give ω's."""
    name = 'part_sums' + ('' if omega is None else '_w')
    extra = {} if omega is None else dict(omega=omega)
    cuda = _on_cuda(name, t_vm=t_vm, a_vm=a_vm, pm=parts.pm, **extra)
    J, Vp = parts.pm.shape
    _, v_t, B = t_vm.shape
    v_a = a_vm.shape[1]
    _expect(name, 't_vm', t_vm, (3, v_t, B))
    _omega_args(name, omega, v_t, B, Vp)
    broadcast = a_vm.dim() == 3 and a_vm.shape[2] == 1 and B > 1
    _expect(name, 'a_vm', a_vm, (3, v_a, 1 if broadcast else B))
    if max(v_t, v_a) > Vp:
        raise ValueError(f'{name}: point rows {max(v_t, v_a)} exceed V_pad {Vp}')
    call_omega = omega is not None and omega.shape != (Vp, 1)
    if _twin_for_constant_grads(name, cuda, parts.pm, None if call_omega else omega):
        return part_sums_ref(t_vm, a_vm, parts.pm, **extra)
    if call_omega:  # no backward kernel: the VJP of the twin in torch ops
        return _part_sums_call_vjp(name, t_vm, a_vm, parts, omega)
    return _PartSums.apply(name, t_vm, a_vm, parts, omega)


def _part_sums_call_vjp(name, t_vm, a_vm, parts: PartIndex, omega):
    """K5 under per-call ω as a _ChunkedVjp: t, a and ω differentiate."""
    def run(t, a, pm, om):
        return _part_sums_run(name, t, a, parts, om)

    return _ChunkedVjp.apply('part_sums_call_w', run, part_sums_ref, t_vm.shape[1],
                             (1, 1, 1, 0), (0, 1, 3), t_vm, a_vm, parts.pm, omega)


def _part_sums_run(name, t_vm, a_vm, parts: PartIndex, omega):
    """Checked K5: its kernel on CUDA tensors, its twin on CPU ones."""
    if not t_vm.is_cuda:
        return part_sums_ref(t_vm, a_vm, parts.pm, **({} if omega is None else dict(omega=omega)))
    J, Vp = parts.pm.shape
    _, v_t, B = t_vm.shape
    om_ptr, om_rows, om_rs, om_bs = _omega_args(name, omega, v_t, B, Vp)
    broadcast = a_vm.shape[2] == 1 and B > 1
    raw, s_t, s_a, part = _part_sums_outputs(name, parts, J, B, t_vm.device)
    err = _build.library().part_sums_launch(
        _ptr(t_vm), _ptr(a_vm), om_ptr, _ptr(parts.verts), _ptr(parts.seg_offset),
        _ptr(parts.part_seg), _ptr(raw), _ptr(s_t), _ptr(s_a), _ptr(part), J, B, v_t,
        a_vm.shape[1], parts.n_seg, int(broadcast), om_rows, om_rs, om_bs, _stream(raw))
    _build.check(err, name)
    LAUNCHES[name] += 1
    if broadcast and om_bs == 0:  # every column's s_a is the same
        s_a = s_a[:, :, :1].contiguous()
    return raw, s_t, s_a


class _PartSums(torch.autograd.Function):
    """K5 (unweighted or static ω) with K15 as its backward: the JAX
    package's _part_sums_diff and _part_sums_w_diff."""

    @staticmethod
    def forward(ctx, name, t_vm, a_vm, parts, omega):
        ctx.parts = parts
        ctx.save_for_backward(t_vm, a_vm, omega)
        return _part_sums_run(name, t_vm, a_vm, parts, omega)

    @staticmethod
    @once_differentiable
    def backward(ctx, graw, gst, gsa):
        t_vm, a_vm, omega = ctx.saved_tensors
        dt, da = part_sums_bwd(graw.contiguous(), gst.contiguous(), gsa.contiguous(), t_vm, a_vm,
                               ctx.parts, omega=omega)
        return None, dt, da, None, None


# ---------------------------------------------------------------------------
# K15: backward of the per-part sums
# ---------------------------------------------------------------------------


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """x (C, V, B) with zero rows appended up to n."""
    if x.shape[1] >= n:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], n - x.shape[1], x.shape[2]))], dim=1)


def _part_sums_bwd_of(pm, graw, gst, gsa, t, a, omega=None):
    """The VJP of :func:`_part_sums_of` (unweighted or a static ω column):
    with W = pm^T graw, dt_c = ω (pm^T gst_c + sum_d W[c*3+d] a_d) (3, V_t, B)
    and da_d = ω (pm^T gsa_d + sum_c W[c*3+d] t_c), (3, V_a, B), or summed
    over the batch, (3, V_a, 1), for a batch-constant a; ω zero past V_t."""
    v_t, v_a = t.shape[1], a.shape[1]
    n = max(v_t, v_a)
    pmn = pm[:, :n]
    W = torch.einsum('jv,xjb->xvb', pmn, graw)
    tp, ap = _pad_rows(t, n), _pad_rows(a, n)
    dt = torch.einsum('jv,cjb->cvb', pmn, gst) + torch.stack(
        [sum(W[c * 3 + d] * ap[d] for d in range(3)) for c in range(3)])
    wt = torch.stack([sum(W[c * 3 + d] * tp[c] for c in range(3)) for d in range(3)])
    if a.shape[2] != t.shape[2]:
        wt = wt.sum(dim=2, keepdim=True)
    da = torch.einsum('jv,djb->dvb', pmn, gsa) + wt
    if omega is not None:
        om = _omega_rows(omega, v_t)
        om = torch.cat([om, om.new_zeros((n - v_t, 1))]) if n > v_t else om
        dt, da = dt * om, da * om
    return dt[:, :v_t].contiguous(), da[:, :v_a].contiguous()


def part_sums_bwd_ref(graw, gst, gsa, t_vm, a_vm, pm, omega=None):
    """Plain twin of :func:`part_sums_bwd` (``pm``: (J, V_pad))."""
    return _part_sums_bwd_of(pm, graw, gst, gsa, t_vm, a_vm, omega)


def part_sums_bwd(graw, gst, gsa, t_vm, a_vm, parts: PartIndex, omega=None):
    """The VJP of :func:`part_sums_vm_lm` (unweighted or a static ``omega``
    (V_pad, 1)) for the cotangents graw (9, J, B), gst (3, J, B) and gsa
    (3, J, B), or (3, J, 1) for a batch-constant reference (the summed form):
    with W = graw at the vertex's own part, dt_c = ω (gst + sum_d W[c*3+d]
    a_d) (3, V_t, B) and da_d = ω (gsa + sum_c W[c*3+d] t_c) (3, V_a, B), or
    summed over the batch, (3, V_a, 1). Returns (dt, da)."""
    B = t_vm.shape[2]
    summed = a_vm.shape[2] == 1 and B > 1
    name = 'part_sums_bwd' + ('_sum' if summed else '') + ('' if omega is None else '_w')
    extra = {} if omega is None else dict(omega=omega)
    cuda = _on_cuda(name, graw=graw, gst=gst, gsa=gsa, t_vm=t_vm, a_vm=a_vm, pm=parts.pm,
                    **extra)
    J, Vp = parts.pm.shape
    v_t, v_a = t_vm.shape[1], a_vm.shape[1]
    _expect(name, 'graw', graw, (9, J, B))
    _expect(name, 'gst', gst, (3, J, B))
    _expect(name, 'gsa', gsa, (3, J, 1 if summed else B))
    _expect(name, 't_vm', t_vm, (3, v_t, B))
    _expect(name, 'a_vm', a_vm, (3, v_a, 1 if summed else B))
    if max(v_t, v_a) > Vp:
        raise ValueError(f'{name}: point rows {max(v_t, v_a)} exceed V_pad {Vp}')
    if omega is not None:
        _omega_strides(name, omega, v_t, B, Vp, static_only=True)
    if not cuda:
        return part_sums_bwd_ref(graw, gst, gsa, t_vm, a_vm, parts.pm, **extra)
    vp = _vpart(name, parts, Vp, graw.device)
    dev = graw.device
    dt = torch.empty((3, v_t, B), dtype=torch.float32, device=dev)
    da = torch.empty((3, v_a, 1 if summed else B), dtype=torch.float32, device=dev)
    part = torch.empty((-(-B // _SUM_COLS) * 3 * v_a if summed else 1,), dtype=torch.float32,
                       device=dev)
    err = _build.library().part_sums_bwd_launch(
        _ptr(graw), _ptr(gst), _ptr(gsa), _ptr(t_vm), _ptr(a_vm),
        None if omega is None else _ptr(omega), _ptr(vp), _ptr(dt), _ptr(da), _ptr(part), J, B,
        v_t, v_a, int(summed), _stream(dt))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return dt, da


def _index_tensors(name: str, device, *tensors) -> None:
    """Index operands (vertex and joint lists) must be contiguous int32 on
    the kernel's device."""
    for t in tensors:
        if t.dtype != torch.int32 or t.device != device or not t.is_contiguous():
            raise ValueError(f'{name}: index lists must be contiguous int32 on {device}')


def _vpart(name: str, parts: PartIndex, Vp: int, device) -> torch.Tensor:
    """The part index's per-vertex parts, checked for a backward kernel."""
    vp = parts.vpart
    if vp.dtype != torch.int32 or vp.device != device or vp.shape != (Vp,):
        raise ValueError(f'{name}: parts.vpart must be int32 ({Vp},) on {device}')
    return vp


# ---------------------------------------------------------------------------
# K6: extended-LBS reconstruction fused into per-part sums
# ---------------------------------------------------------------------------


def recon_part_sums_ref(tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, pm, omega=None):
    """Plain twin of :func:`recon_part_sums_lm` (``pm``: (J, V_pad))."""
    return _part_sums_of(pm, tgt_vm, lbs_points_ref(pj_cm, feat_cols, weights_pad, consts_pad),
                         omega)


def recon_part_sums_lm(tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, parts: PartIndex,
                       omega=None):
    """Per-part sums (as :func:`part_sums_vm_lm`, with its ``omega``) of the
    targets against the extended LBS of :func:`lbs_points`, which the kernel
    never writes out. Gradients: unweighted or with static ω, K14
    (:func:`recon_part_sums_bwd`); with per-call ω, torch ops."""
    name = 'recon_part_sums' + ('' if omega is None else '_w')
    extra = {} if omega is None else dict(omega=omega)
    cuda = _on_cuda(name, tgt_vm=tgt_vm, pj_cm=pj_cm, feat_cols=feat_cols,
                    weights_pad=weights_pad, consts_pad=consts_pad, pm=parts.pm, **extra)
    _, J, B = pj_cm.shape
    F = feat_cols.shape[0]
    Vp = weights_pad.shape[0]
    v_t = tgt_vm.shape[1]
    _expect(name, 'tgt_vm', tgt_vm, (3, v_t, B))
    _expect(name, 'feat_cols', feat_cols, (F, B))
    _expect(name, 'weights_pad', weights_pad, (Vp, J))
    _expect(name, 'consts_pad', consts_pad, (None, Vp, F))
    _expect(name, 'pm', parts.pm, (J, Vp))
    if v_t > Vp:
        raise ValueError(f'{name}: target rows {v_t} exceed V_pad {Vp}')
    if consts_pad.shape[0] < 3:
        raise ValueError(f'{name}: consts_pad needs at least 3 channels')
    _omega_args(name, omega, v_t, B, Vp)
    args = (name, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, parts, omega)
    call_omega = omega is not None and omega.shape != (Vp, 1)
    if _twin_for_constant_grads(name, cuda, weights_pad, consts_pad, parts.pm,
                                None if call_omega else omega):
        return _recon_lbs_run(*args)
    if call_omega:  # no backward kernel: the VJP of the twin in torch ops
        return _recon_call_vjp(*args)
    return _ReconLbs.apply(*args)


def _recon_call_vjp(name, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, parts, omega):
    """K6 under per-call ω as a _ChunkedVjp: tgt, pj, feat and ω
    differentiate."""
    def run(tgt, pj, feat, w, consts, pm, om):
        return _recon_lbs_run(name, tgt, pj, feat, w, consts, parts, om)

    return _ChunkedVjp.apply('recon_part_sums_call_w', run, recon_part_sums_ref, tgt_vm.shape[1],
                             (1, None, None, 0, 1, 1, 0), (0, 1, 2, 6), tgt_vm, pj_cm, feat_cols,
                             weights_pad, consts_pad, parts.pm, omega)


def _recon_lbs_run(name, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, parts, omega):
    """Checked K6: its kernel on CUDA tensors, its twin on CPU ones."""
    if not tgt_vm.is_cuda:
        return recon_part_sums_ref(tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, parts.pm,
                                   **({} if omega is None else dict(omega=omega)))
    _, J, B = pj_cm.shape
    F = feat_cols.shape[0]
    Vp = weights_pad.shape[0]
    v_t = tgt_vm.shape[1]
    om_ptr, om_rows, om_rs, om_bs = _omega_args(name, omega, v_t, B, Vp)
    _index_tensors(name, tgt_vm.device, parts.joints, parts.joint_offset)
    raw, s_t, s_a, part = _part_sums_outputs(name, parts, J, B, tgt_vm.device)
    err = _build.library().recon_lbs_part_sums_launch(
        _ptr(tgt_vm), _ptr(pj_cm), _ptr(feat_cols), _ptr(weights_pad), _ptr(consts_pad),
        om_ptr, _ptr(parts.verts), _ptr(parts.seg_offset), _ptr(parts.joints),
        _ptr(parts.joint_offset), _ptr(parts.part_seg), _ptr(raw), _ptr(s_t), _ptr(s_a),
        _ptr(part), J, B, F, v_t, Vp, parts.n_seg, om_rows, om_rs, om_bs, _stream(raw))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return raw, s_t, s_a


class _ReconLbs(torch.autograd.Function):
    """K6 (unweighted or static ω) with K14 as its backward: the JAX
    package's _recon_part_sums_diff and _recon_part_sums_w_diff."""

    @staticmethod
    def forward(ctx, name, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, parts, omega):
        ctx.parts = parts
        ctx.save_for_backward(tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, omega)
        return _recon_lbs_run(name, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, parts,
                              omega)

    @staticmethod
    @once_differentiable
    def backward(ctx, graw, gst, gsa):
        tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad, omega = ctx.saved_tensors
        dtgt, dpj, dfeat = recon_part_sums_bwd(
            graw.contiguous(), gst.contiguous(), gsa.contiguous(), tgt_vm, pj_cm, feat_cols,
            weights_pad, consts_pad, ctx.parts, omega=omega)
        return None, dtgt, dpj, dfeat, None, None, None, None


# ---------------------------------------------------------------------------
# K14: backward of the fused reconstruction's part sums
# ---------------------------------------------------------------------------


def recon_part_sums_bwd_ref(graw, gst, gsa, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad,
                            pm, omega=None):
    """Plain twin of :func:`recon_part_sums_bwd` (``pm``: (J, V_pad))."""
    pos = lbs_points_ref(pj_cm, feat_cols, weights_pad, consts_pad)
    dtgt, dpos = _part_sums_bwd_of(pm, graw, gst, gsa, tgt_vm, pos, omega)
    dpj, dfeat = lbs_points_bwd_ref(dpos, pj_cm, feat_cols, weights_pad, consts_pad)
    return dtgt, dpj, dfeat


def recon_part_sums_bwd(graw, gst, gsa, tgt_vm, pj_cm, feat_cols, weights_pad, consts_pad,
                        parts: PartIndex, omega=None):
    """The VJP of :func:`recon_part_sums_lm` (unweighted or a static
    ``omega`` (V_pad, 1)) for the cotangents graw (9, J, B), gst and gsa
    (3, J, B): with pos the extended LBS and W = graw at the vertex's own
    part, dtgt_c = ω (gst + sum_d W[c*3+d] pos_d) (3, V_t, B) and dpos_d =
    ω (gsa + sum_c W[c*3+d] t_c), which :func:`lbs_points_bwd`'s formula
    takes to dpj (12, J, B) and dfeat (F, B). Returns (dtgt, dpj, dfeat)."""
    name = 'recon_part_sums_bwd' + ('' if omega is None else '_w')
    extra = {} if omega is None else dict(omega=omega)
    cuda = _on_cuda(name, graw=graw, gst=gst, gsa=gsa, tgt_vm=tgt_vm, pj_cm=pj_cm,
                    feat_cols=feat_cols, weights_pad=weights_pad, consts_pad=consts_pad,
                    pm=parts.pm, **extra)
    _, J, B = pj_cm.shape
    F = feat_cols.shape[0]
    Vp = weights_pad.shape[0]
    v_t = tgt_vm.shape[1]
    _expect(name, 'graw', graw, (9, J, B))
    _expect(name, 'gst', gst, (3, J, B))
    _expect(name, 'gsa', gsa, (3, J, B))
    _expect(name, 'tgt_vm', tgt_vm, (3, v_t, B))
    _expect(name, 'feat_cols', feat_cols, (F, B))
    _expect(name, 'weights_pad', weights_pad, (Vp, J))
    _expect(name, 'consts_pad', consts_pad, (None, Vp, F))
    _expect(name, 'pm', parts.pm, (J, Vp))
    if v_t > Vp:
        raise ValueError(f'{name}: target rows {v_t} exceed V_pad {Vp}')
    if omega is not None:
        _omega_strides(name, omega, v_t, B, Vp, static_only=True)
    if consts_pad.shape[0] < 3:
        raise ValueError(f'{name}: consts_pad needs at least 3 channels')
    if not cuda:
        return recon_part_sums_bwd_ref(graw, gst, gsa, tgt_vm, pj_cm, feat_cols, weights_pad,
                                       consts_pad, parts.pm, **extra)
    dev = graw.device
    vp = _vpart(name, parts, Vp, dev)
    _index_tensors(name, dev, parts.verts, parts.tile_offset, parts.tile_seg, parts.joints,
                   parts.joint_offset, parts.unused)
    if parts.verts.shape[0] + parts.unused.shape[0] != Vp:
        raise ValueError(f'{name}: the part index does not hold each of the {Vp} rows once')
    per_run, n_runs = _segment_runs(parts.n_tiles, B, dev, 1)
    n_runs = max(n_runs, 1)
    splits = dfeat_splits(F, B, Vp, dev)
    dtgt, out = _f32(dev, 3, v_t, B), _f32(dev, 12 * J + F, B)
    H, U = _f32(dev, 3, Vp, B), _f32(dev, 3, Vp, B)
    part = _f32(dev, n_runs, 12 * J, B)
    part_feat = _f32(dev, splits, F, B) if splits > 1 else None
    err = _build.library().recon_lbs_bwd_launch(
        _ptr(graw), _ptr(gst), _ptr(gsa), _ptr(tgt_vm), _ptr(pj_cm), _ptr(feat_cols),
        _ptr(weights_pad), _ptr(consts_pad), None if omega is None else _ptr(omega),
        _ptr(parts.verts), _ptr(parts.tile_offset), _ptr(parts.tile_seg), _ptr(parts.joints),
        _ptr(parts.joint_offset), _ptr(vp), _ptr(parts.unused), _ptr(dtgt), _ptr(H), _ptr(U),
        _ptr(part), None if part_feat is None else _ptr(part_feat), _ptr(out), J, B, F, v_t, Vp,
        parts.n_tiles, parts.unused.shape[0], per_run, splits, _stream(out))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return dtgt, out[:12 * J].view(12, J, B), out[12 * J:]


# ---------------------------------------------------------------------------
# K9: centred normal equations of the shape solve under per-call fit weights
# ---------------------------------------------------------------------------

_WGRAM_VCHUNK = 1024  # vertices per step of the plain twin (bounds its memory)


def wgram_moments_ref(tgt_vm, pj_cm, homog_vm, t4_cm, weights_pad, sd_cm, mu_cm, omega_vm,
                      mu_s=None, scale_mode: int = 0, cover=None):
    """Plain twin of :func:`wgram_moments`, in steps of vertices: the
    dense blend over every joint (``cover`` only serves the kernel)."""
    V, B = omega_vm.shape
    E = sd_cm.shape[2]
    E1 = E + (1 if scale_mode else 0)
    dev = tgt_vm.device
    G = torch.zeros((E1, E1, B), device=dev)
    SA = torch.zeros((3, E1, B), device=dev)
    r = torch.zeros((E1, B), device=dev)
    Sb = torch.zeros((3, B), device=dev)
    mu = mu_cm.reshape(3, E, 1, B)
    for v0 in range(0, V, _WGRAM_VCHUNK):
        v1 = min(V, v0 + _WGRAM_VCHUNK)
        w = weights_pad[v0:v1]
        blend = torch.einsum('vj,xjb->xvb', w, pj_cm)
        pos = _apply_blend(blend, homog_vm[:, v0:v1])
        t = tgt_vm[:, v0:v1]
        b = t - pos
        om = omega_vm[v0:v1]
        tbar = torch.einsum('vj,xjb->xvb', w, t4_cm).reshape(3, E, v1 - v0, B)
        sd = sd_cm[:, v0:v1]  # (3, n, E)
        rsd = torch.stack([
            sum(blend[a * 4 + c][None] * sd[c].T[:, :, None] for c in range(3))
            for a in range(3)])  # (3, E, n, B)
        jac = tbar + rsd - mu
        if scale_mode:
            col = -t if scale_mode == 1 else pos
            jac = torch.cat([jac, (col - mu_s[:, None, :])[:, None]], dim=1)
        jw = jac * om
        G += torch.einsum('aevb,afvb->efb', jw, jac)
        SA += jw.sum(dim=2)
        r += torch.einsum('aevb,avb->eb', jw, b)
        Sb += (b * om).sum(dim=1)
    W = omega_vm.sum(dim=0, keepdim=True)
    return (G.reshape(E1 * E1, B), SA.reshape(3 * E1, B), r, Sb, W)


def wgram_moments(tgt_vm, pj_cm, homog_vm, t4_cm, weights_pad, sd_cm, mu_cm, omega_vm,
                  mu_s=None, scale_mode: int = 0, cover: BlendSegments | None = None):
    """The shape solve's normal equations under per-call fit weights ω.

    For each vertex v < V (the rows of ``omega_vm`` (V, B)) and column b: the
    blended [R|t] of the skinning weights applied to the posed template
    ``homog_vm`` (3, V_pad, B) gives pos; the residual is b = tgt - pos
    (``tgt_vm`` (3, V, B)); the beta-Jacobian is jac[a, e] = sum_j w_vj
    T4[a*E+e, j] + sum_c Rbar[a, c] SD_v[c, e] - mu[a*E+e] (``t4_cm``
    (3E, J, B), ``sd_cm`` (3, V_pad, E), the centring mean ``mu_cm``
    (3E, B)); ``scale_mode`` 1 (scale_target) or 2 (scale_fit) appends the
    column -tgt or pos minus ``mu_s`` (3, B). Returns G (E1^2, B) = sum ω
    jac^T jac, SA (3E1, B) = sum ω jac, r (E1, B) = sum ω jac^T b, Sb (3, B) =
    sum ω b and W (1, B) = sum ω, E1 = E (+1 with the scale column); E <= 32.
    ω >= 0: the kernel weights each row by sqrt(ω), as the TPU kernel does.

    ``cover`` (:func:`wgram_cover` of ``weights_pad``, as the fitter's
    GramData holds it) is the segment cover the kernel walks, blending over
    each segment's active joints; None builds it from ``weights_pad`` on the
    host (a copy from the card at every call)."""
    name = 'wgram'
    tensors = dict(tgt_vm=tgt_vm, pj_cm=pj_cm, homog_vm=homog_vm, t4_cm=t4_cm,
                   weights_pad=weights_pad, sd_cm=sd_cm, mu_cm=mu_cm, omega_vm=omega_vm)
    if scale_mode not in (0, 1, 2):
        raise ValueError(f'{name}: scale_mode must be 0, 1 or 2, got {scale_mode}')
    if (mu_s is not None) != bool(scale_mode):
        raise ValueError(f'{name}: mu_s is required exactly when scale_mode is set')
    if mu_s is not None:
        tensors['mu_s'] = mu_s
    cuda = _on_cuda(name, **tensors)
    _, J, B = pj_cm.shape
    Vp = weights_pad.shape[0]
    V = omega_vm.shape[0]
    E = sd_cm.shape[2]
    _expect(name, 'omega_vm', omega_vm, (V, B))
    _expect(name, 'tgt_vm', tgt_vm, (3, V, B))
    _expect(name, 'pj_cm', pj_cm, (12, J, B))
    _expect(name, 'homog_vm', homog_vm, (3, Vp, B))
    _expect(name, 't4_cm', t4_cm, (3 * E, J, B))
    _expect(name, 'weights_pad', weights_pad, (Vp, J))
    _expect(name, 'sd_cm', sd_cm, (3, Vp, E))
    _expect(name, 'mu_cm', mu_cm, (3 * E, B))
    if mu_s is not None:
        _expect(name, 'mu_s', mu_s, (3, B))
    if V > Vp:
        raise ValueError(f'{name}: weight rows {V} exceed V_pad {Vp}')
    if cuda and E > _WGRAM_MAXE:
        raise ValueError(f'{name}: the kernel takes E <= {_WGRAM_MAXE}, got {E}')
    args = (tgt_vm, pj_cm, homog_vm, t4_cm, weights_pad, sd_cm, mu_cm, omega_vm, mu_s)
    if _twin_for_constant_grads(name, cuda, weights_pad, sd_cm):
        return wgram_moments_ref(*args, scale_mode)
    if cuda:
        if cover is None:
            HOST_COVERS[name] += 1
            cover = wgram_cover(weights_pad.detach().cpu().numpy(), V, tgt_vm.device)
        if cover.covers < V:
            raise ValueError(f'{name}: the cover holds vertices < {cover.covers}, not all < {V}')
        _index_tensors(name, tgt_vm.device, cover.verts, cover.seg_offset, cover.joints,
                       cover.joint_offset)
    return _wgram_vjp(*args, scale_mode=scale_mode, cover=cover)  # no backward kernel: torch ops


def _wgram_vjp(*args, scale_mode: int, cover=None):
    """K9 as a _ChunkedVjp: every operand but the skinning weights and the
    shape directions differentiates."""
    def run(*ops):
        return _wgram_run(*ops, scale_mode, cover)

    def chunk(*ops):
        return wgram_moments_ref(*ops, scale_mode)

    return _ChunkedVjp.apply('wgram', run, chunk, args[7].shape[0],
                             (1, None, 1, None, 0, 1, None, 0, None), (0, 1, 2, 3, 6, 7, 8),
                             *args)


def _wgram_run(tgt_vm, pj_cm, homog_vm, t4_cm, weights_pad, sd_cm, mu_cm, omega_vm, mu_s,
               scale_mode, cover=None):
    """Checked K9: its kernel on CUDA tensors, its twin on CPU ones."""
    if not tgt_vm.is_cuda:
        return wgram_moments_ref(tgt_vm, pj_cm, homog_vm, t4_cm, weights_pad, sd_cm, mu_cm,
                                 omega_vm, mu_s, scale_mode)
    name = 'wgram'
    _, J, B = pj_cm.shape
    Vp = weights_pad.shape[0]
    V = omega_vm.shape[0]
    E = sd_cm.shape[2]
    lib = _build.library()
    E1 = E + (1 if scale_mode else 0)
    dev = tgt_vm.device
    plan = wgram_plan(J, E, scale_mode, cover.max_joints, cover.n_seg, B,
                      torch.cuda.get_device_properties(dev).multi_processor_count)
    part = torch.empty((plan.n_splits, plan.part_floats, B), dtype=torch.float32, device=dev)
    G = torch.empty((E1 * E1, B), dtype=torch.float32, device=dev)
    SA = torch.empty((3 * E1, B), dtype=torch.float32, device=dev)
    r = torch.empty((E1, B), dtype=torch.float32, device=dev)
    Sb = torch.empty((3, B), dtype=torch.float32, device=dev)
    W = torch.empty((1, B), dtype=torch.float32, device=dev)
    err = lib.wgram_launch(
        _ptr(tgt_vm), _ptr(pj_cm), _ptr(homog_vm), _ptr(t4_cm), _ptr(weights_pad), _ptr(sd_cm),
        _ptr(mu_cm), _ptr(omega_vm), None if mu_s is None else _ptr(mu_s), _ptr(cover.verts),
        _ptr(cover.seg_offset), _ptr(cover.joints), _ptr(cover.joint_offset), _ptr(part),
        _ptr(G), _ptr(SA), _ptr(r), _ptr(Sb), _ptr(W), J, E, B, V, Vp, scale_mode, cover.n_seg,
        plan.n_splits, cover.max_joints, plan.columns, plan.tasks_per_lane, plan.row_groups,
        plan.part_floats, _stream(G))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return G, SA, r, Sb, W


_WGRAM_MAXE = 32  # csrc/wgram.cu's largest instance
_WGRAM_ROWS = 3 * _WGRAM_SEG  # rows (vertex, axis) of a segment
_WGRAM_SMEM = 227 * 1024  # shared memory a block may use
_WGRAM_GROUPS = (1, 2, 3, 4, 6, 8)  # row groups: divisors of the 96 rows


@dataclass(frozen=True)
class WgramPlan:
    """K9's launch on one call's shapes (csrc/wgram.cu checks it): the
    augmented Gram's entries padded to ``padded`` (a multiple of 4) and its
    upper-triangle 4 x 4 ``blocks``; ``columns`` batch columns per block
    (a warp each: 8, fewer where every joint's entries would not fit shared
    memory); per column ``row_groups`` x ``blocks`` tasks over its 32 lanes,
    ``tasks_per_lane`` each; ``n_splits`` of the cover's segments; scratch
    of ``part_floats`` floats per split and column; ``smem_bytes`` per block."""

    padded: int
    blocks: int
    columns: int
    tasks_per_lane: int
    row_groups: int
    n_splits: int
    part_floats: int
    smem_bytes: int


def _wgram_smem(J: int, E: int, scale: bool, columns: int, max_joints: int, cap: int) -> int:
    """Shared-memory bytes of a K9 block (csrc/wgram.cu: dims_of, smem_floats)."""
    E1 = E + int(scale)
    NP = -(-(E1 + 4) // 4) * 4
    RS = NP if NP % 8 == 4 else NP + 4
    EA = -(-E // 4) * 4
    AS, MS = 4 + EA, EA + 4
    SDS = 3 * EA if 3 * EA % 8 == 4 else 3 * EA + 4
    A = max(1, max_joints)
    floats = (columns * J * 3 * AS + columns * 3 * MS + columns * _WGRAM_ROWS * RS
              + 2 * _WGRAM_SEG * SDS + 2 * 7 * _WGRAM_SEG * (columns + 4) + 2 * A * _WGRAM_SEG
              + 3 * _WGRAM_SEG + 3 * A + 2 * (cap + 1))
    return 4 * floats


def wgram_plan(J: int, E: int, scale_mode: int, max_joints: int, n_seg: int, B: int,
               sms: int) -> WgramPlan:
    """The launch plan of K9 (:class:`WgramPlan`): the most batch columns per
    block whose shared memory fits, the task split that keeps the most lanes
    busy (one task per lane on a tie), and enough splits of the segments
    that the grid holds about two blocks per SM."""
    if not 1 <= E <= _WGRAM_MAXE:
        raise ValueError(f'wgram: the kernel takes 1 <= E <= {_WGRAM_MAXE}, got {E}')
    scale = bool(scale_mode)
    NP = -(-(E + int(scale) + 4) // 4) * 4
    blocks = (NP // 4) * (NP // 4 + 1) // 2
    columns = next((c for c in (8, 4, 2)
                    if _wgram_smem(J, E, scale, c, max_joints, n_seg) <= _WGRAM_SMEM), None)
    if columns is None:
        raise ValueError(f'wgram: J = {J} joints at E = {E} do not fit a block\'s shared memory')
    best = None
    for mt in (1, 2):
        for kg in _WGRAM_GROUPS:
            if kg * blocks <= 32 * mt and (best is None or kg * blocks / (32 * mt) > best[0] + 1e-9):
                best = (kg * blocks / (32 * mt), mt, kg)
    grid_x = -(-B // columns)
    n_splits = max(1, min(n_seg, math.ceil(2 * sms / grid_x)))
    cap = -(-n_seg // n_splits)
    return WgramPlan(padded=NP, blocks=blocks, columns=columns, tasks_per_lane=best[1],
                     row_groups=best[2], n_splits=n_splits, part_floats=16 * blocks,
                     smem_bytes=_wgram_smem(J, E, scale, columns, max_joints, cap))


# wrapper -> its plain twin
TWINS = {
    'lbs_points': lbs_points_ref,
    'rhs_moments_h': rhs_moments_h_ref,
    'rhs_moments': rhs_moments_ref,
    'rhs_moments_cached': rhs_moments_cached_ref,
    'gram_assembly': gram_assembly_ref,
    'recon_part_sums_cached_lm': recon_part_sums_cached_ref,
    'part_sums_vm_lm': part_sums_ref,
    'recon_part_sums_lm': recon_part_sums_ref,
    'posed_template_lm': posed_template_ref,
    'term1': term1_ref,
    'wgram_moments': wgram_moments_ref,
    'lbs_points_bwd': lbs_points_bwd_ref,
    'rhs_moments_bwd': rhs_moments_bwd_ref,
    'rhs_moments_cached_bwd': rhs_moments_cached_bwd_ref,
    'recon_part_sums_cached_bwd': recon_part_sums_cached_bwd_ref,
    'part_sums_bwd': part_sums_bwd_ref,
    'recon_part_sums_bwd': recon_part_sums_bwd_ref,
}


def twin_call(wrapper: str, args, kwargs) -> tuple:
    """The plain twin of ``wrapper`` on the wrapper's own arguments (a
    PartIndex becomes its membership matrix, a cover is left out), as a
    tuple of outputs."""
    args = [a.pm if isinstance(a, PartIndex) else a for a in args]
    out = TWINS[wrapper](*args, **{k: v for k, v in kwargs.items() if k != 'cover'})
    return out if isinstance(out, tuple) else (out,)
