#!/usr/bin/env python3
"""Where the time of one fitting path goes on an NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA device:

    python3 chip_profile.py [--model smplx] [--path headline] [--grad] [--gram-routes]
    python3 chip_profile.py [--model smplx] --grad-path c_known_shape
    python3 chip_profile.py --model smpl --share-beta [--path f_call_weights]
    python3 chip_profile.py --model smpl --subset 1024 --batch 16384

``--path`` takes the headline, ``chip_smoke.PATHS`` (a-e) or the fit-weight
paths ``chip_smoke.WPATHS`` (f-l, with ``chip_smoke``'s seeded weights).
``--grad`` profiles the path's value and gradient instead: the summed squares
of its pose rotation vectors, betas and translation (the default loss of
``get_fit_grad_fn``) differentiated with respect to the targets, for the
paths that return them (the headline, h). ``--grad-path`` profiles the value
and gradient of a ``chip_smoke.GRAD_PATHS`` path instead (``chip_smoke.path_vg``:
its loss and inputs, the gradient in the targets it differentiates), as
``chip_smoke.py`` phase 14 times it. ``--share-beta`` runs the path with one
shape for the batch, as ``chip_smoke.SHARE_PATHS`` calls it (the headline,
``d_known_pose``, ``f_call_weights``). ``--subset N`` loads the model on its
N-vertex subset (``BodyModel(vertex_subset_size=N)``, decimated where the
file is missing), and ``--batch`` sets the batch (default
``chip_smoke.BATCH``).

It builds the kernels, loads the synthetic model at full width (as
``chip_smoke.py`` does), makes one target set of the batch (4096 by default)
with the forward pass and then:

1. times the path unprofiled: the median of 5 calls between CUDA events;
2. runs it twice under ``torch.profiler`` and prints, per call, the device
   time and launches of the largest kernels, the device busy time, its share
   of the unprofiled call time, and the device launches;
3. with ``--gram-routes``, times the Gramian of the path's shape solves both
   ways on the same operands: K3 alone (where the model takes it: its shared
   memory holds 16 columns' operands at small J only), and the streamed
   route that the port takes at large J (K8 plus the other parts in tensor
   ops), and K8 alone; each route's result is checked against the twin
   first.

Every line names the card and its power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

import chip_smoke


def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--model', default='smplx', choices=sorted(chip_smoke.MODELS))
    parser.add_argument('--path', default='headline',
                        choices=['headline', *chip_smoke.PATHS, *chip_smoke.WPATHS])
    parser.add_argument('--grad', action='store_true')
    parser.add_argument('--gram-routes', action='store_true')
    parser.add_argument('--grad-path', choices=sorted(chip_smoke.GRAD_PATHS))
    parser.add_argument('--share-beta', action='store_true')
    parser.add_argument('--subset', type=int, default=None)
    parser.add_argument('--batch', type=int, default=chip_smoke.BATCH)
    args = parser.parse_args()
    batch = args.batch
    if args.share_beta and f'{args.model} {args.path}' not in chip_smoke.SHARE_PATHS:
        parser.error(f'--share-beta: no shared-shape path {args.model} {args.path} '
                     f'(chip_smoke.SHARE_PATHS: {sorted(chip_smoke.SHARE_PATHS)})')
    if not torch.cuda.is_available():
        print('chip_profile: no CUDA device available', file=sys.stderr)
        return 1

    import smplfitter_tpu_torch as port
    from smplfitter_tpu_torch.ops import _build, lbs_kernels
    from smplfitter_tpu_torch.utils import profiling, synthetic

    dev = torch.device('cuda', 0)
    smi = chip_smoke.nvidia_smi_line()
    _build.library()
    models_dir = synthetic.ensure_cached_models(
        os.path.join(_build.BUILD_ROOT, 'synthetic_models'))
    bm = port.BodyModel(args.model, 'neutral', model_root=os.path.join(models_dir, args.model),
                        vertex_subset_size=args.subset, device=dev)
    fitter = port.BodyFitter(bm)
    fitter_kid = port.BodyFitter(bm, enable_kid=True) if args.model != 'mano' else None
    rng = np.random.default_rng(chip_smoke.SEED)
    p = tuple(torch.as_tensor(x, device=dev)
              for x in chip_smoke.random_params(rng, batch, args.model))
    p += (torch.as_tensor(chip_smoke.kid_factors(rng, batch), device=dev),)
    out = bm(*p[:3])
    tv, tj = out['vertices'].contiguous(), out['joints'].contiguous()
    if args.grad_path:
        fs = dict(chip_smoke.weighted_fitters(port, bm, args.model, rng, fitter), kid=fitter_kid)
        p += tuple(chip_smoke.fit_weights(torch, rng, batch, n, dev)
                   for n in (bm.num_vertices, bm.num_joints))
        vg = chip_smoke.path_vg(torch, args.grad_path, fs, p)
    elif args.share_beta:
        path = chip_smoke.SHARE_PATHS[f'{args.model} {args.path}']
        fs = chip_smoke.weighted_fitters(port, bm, args.model, rng, fitter)
        p += tuple(chip_smoke.fit_weights(torch, rng, batch, n, dev)
                   for n in (bm.num_vertices, bm.num_joints))

        def call(tv, tj):
            return path['run'](fs, tv, tj, p)
    elif args.path in chip_smoke.WPATHS:
        path = chip_smoke.WPATHS[args.path]
        fs = chip_smoke.weighted_fitters(port, bm, args.model, rng, fitter)
        p += tuple(chip_smoke.fit_weights(torch, rng, batch, n, dev)
                   for n in (bm.num_vertices, bm.num_joints))

        def call(tv, tj):
            return path['run'](fs, tv, tj, p)
    else:
        path = chip_smoke.HEADLINE if args.path == 'headline' else chip_smoke.PATHS[args.path]

        def call(tv, tj):
            return path['run'](fitter, fitter_kid, tv, tj, p)

    def run():
        if args.grad_path:
            return vg(tv, tj)
        if not args.grad:
            return call(tv, tj)
        tv_g, tj_g = tv.detach().requires_grad_(), tj.detach().requires_grad_()
        return torch.autograd.grad(port.api.default_loss(call(tv_g, tj_g)), (tv_g, tj_g))

    what = (f'{args.model} {args.grad_path} value+grad' if args.grad_path else
            f'{args.model} {args.path}{" share_beta" if args.share_beta else ""}'
            f'{" value+grad" if args.grad else ""}')
    if args.subset:
        what += f' on a {bm.num_vertices}-vertex subset'
    what += f' B={batch}'
    call_ms = profiling.time_ms(run, [()] * 5)
    print(f'{what}: {call_ms:.3f} ms per call unprofiled (median of 5, CUDA events), '
          f'{batch / call_ms * 1e3:.1f} fits/s on {smi}', flush=True)

    n_prof = 2
    by_name = profiling.device_kernels(run, n_calls=n_prof, cpu=True)
    busy_ms = sum(v[0] for v in by_name.values()) / n_prof
    launches = sum(v[1] for v in by_name.values()) / n_prof
    print(f'{what}: device busy {busy_ms:.3f} ms per call, {busy_ms / call_ms:.3f} of the '
          f'unprofiled call; {launches:.0f} device launches per call (torch.profiler over '
          f'{n_prof} calls) on {smi}', flush=True)
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f'  {ms / n_prof:9.3f} ms  {n / n_prof:6.0f} x  {name[:110]}', flush=True)

    if args.gram_routes:
        calls = []
        original = lbs_kernels.gram_assembly

        def recorder(*a, **kw):
            calls.append((a, kw))
            return original(*a, **kw)

        lbs_kernels.gram_assembly = recorder
        try:
            run()
        finally:
            lbs_kernels.gram_assembly = original
        sets = [a for a, kw in calls if kw == calls[0][1]]
        kw = calls[0][1]
        J3, E = sets[0][0].shape[1], sets[0][7].shape[1]  # R_cm (3, J3, B), sd1_2d (J3, E)

        def fused(*a):
            streams = lbs_kernels.streams_term1
            lbs_kernels.streams_term1 = lambda j3, e: False  # take K3 whatever J is
            try:
                return lbs_kernels.gram_assembly(*a, **kw)
            finally:
                lbs_kernels.streams_term1 = streams

        def streamed(*a):
            streams = lbs_kernels.streams_term1
            lbs_kernels.streams_term1 = lambda j3, e: True
            try:
                return lbs_kernels.gram_assembly(*a, **kw)
            finally:
                lbs_kernels.streams_term1 = streams

        # K3 stages 16 columns' R, T and P in shared memory: at SMPL-X widths
        # (J3 = 165, E = 16) that is past the card's 227 KB, so only the
        # streamed route is timed there.
        routes = {'K8 + parts': streamed}
        if not lbs_kernels.streams_term1(J3, E):
            routes = {'K3': fused, **routes}
        want = lbs_kernels.gram_assembly_ref(*sets[0], **kw)
        for name, route in routes.items():
            got = route(*sets[0])
            rel = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))
            print(f'{what}: Gramian by {name}: max rel err vs the fused twin {rel:.2e}',
                  flush=True)
        times = {name: profiling.time_ms(route, sets) for name, route in routes.items()}
        t_k8 = profiling.time_ms(lbs_kernels.term1, [(a[0], a[5]) for a in sets])
        print(f'{what}: Gramian (J3={J3}, E={E}, {len(sets)} calls): '
              + '; '.join(f'{name} {ms:.3f} ms' for name, ms in times.items())
              + f' (K8 alone {t_k8:.3f} ms) per call on {smi}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
