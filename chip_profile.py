#!/usr/bin/env python3
"""Where the time of one fitting path goes on an NVIDIA GPU.

Usage, from the repository root on a machine with a CUDA device:

    python3 chip_profile.py [--model smplx] [--path headline] [--grad] [--gram-routes]
    python3 chip_profile.py [--model smplx] --grad-path c_known_shape

``--path`` takes the headline, ``chip_smoke.PATHS`` (a-e) or the fit-weight
paths ``chip_smoke.WPATHS`` (f-l, with ``chip_smoke``'s seeded weights).
``--grad`` profiles the path's value and gradient instead: the summed squares
of its pose rotation vectors, betas and translation (the default loss of
``get_fit_grad_fn``) differentiated with respect to the targets, for the
paths that return them (the headline, h). ``--grad-path`` profiles the value
and gradient of a ``chip_smoke.GRAD_PATHS`` path instead (``chip_smoke.path_vg``:
its loss and inputs, the gradient in the targets it differentiates), as
``chip_smoke.py`` phase 14 times it.

It builds the kernels, loads the synthetic model at full width (as
``chip_smoke.py`` does), makes one target set of ``chip_smoke.BATCH`` (4096)
with the forward pass and then:

1. times the path unprofiled: the median of 5 calls between CUDA events;
2. runs it twice under ``torch.profiler`` and prints, per call, the device
   time and launches of the largest kernels, the device busy time, its share
   of the unprofiled call time, and the device launches;
3. with ``--gram-routes``, times the Gramian of the path's shape solves both
   ways on the same operands: the fused kernel K3 alone, and the streamed
   route that the port takes at large J (K8 plus the other parts in tensor
   ops), and K8 alone; K3's result is checked against its twin first.

Every line names the card and its power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import os
import statistics
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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print('chip_profile: no CUDA device available', file=sys.stderr)
        return 1

    import smplfitter_tpu_torch as port
    from smplfitter_tpu_torch.ops import _build, lbs_kernels
    from smplfitter_tpu_torch.utils import synthetic

    dev = torch.device('cuda', 0)
    smi = chip_smoke.nvidia_smi_line()
    _build.library()
    models_dir = synthetic.ensure_cached_models(
        os.path.join(_build.BUILD_ROOT, 'synthetic_models'))
    bm = port.BodyModel(args.model, 'neutral', model_root=os.path.join(models_dir, args.model),
                        device=dev)
    fitter = port.BodyFitter(bm)
    fitter_kid = port.BodyFitter(bm, enable_kid=True) if args.model != 'mano' else None
    rng = np.random.default_rng(chip_smoke.SEED)
    p = tuple(torch.as_tensor(x, device=dev)
              for x in chip_smoke.random_params(rng, chip_smoke.BATCH, args.model))
    p += (torch.as_tensor(chip_smoke.kid_factors(rng, chip_smoke.BATCH), device=dev),)
    out = bm(*p[:3])
    tv, tj = out['vertices'].contiguous(), out['joints'].contiguous()
    if args.grad_path:
        fs = dict(chip_smoke.weighted_fitters(port, bm, args.model, rng, fitter), kid=fitter_kid)
        p += tuple(chip_smoke.fit_weights(torch, rng, chip_smoke.BATCH, n, dev)
                   for n in (bm.num_vertices, bm.num_joints))
        vg = chip_smoke.path_vg(torch, args.grad_path, fs, p)
    elif args.path in chip_smoke.WPATHS:
        path = chip_smoke.WPATHS[args.path]
        fs = chip_smoke.weighted_fitters(port, bm, args.model, rng, fitter)
        p += tuple(chip_smoke.fit_weights(torch, rng, chip_smoke.BATCH, n, dev)
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
            f'{args.model} {args.path}{" value+grad" if args.grad else ""}')
    what += f' B={chip_smoke.BATCH}'
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    call_ms = statistics.median(times)
    print(f'{what}: {call_ms:.3f} ms per call unprofiled (median of 5, CUDA events), '
          f'{chip_smoke.BATCH / call_ms * 1e3:.1f} fits/s on {smi}', flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    n_prof = 2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            run()
        torch.cuda.synchronize()
    by_name: dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            entry = by_name.setdefault(e.name, [0.0, 0])
            entry[0] += e.time_range.elapsed_us() / 1e3
            entry[1] += 1
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

        want = lbs_kernels.gram_assembly_ref(*sets[0], **kw)
        for name, route in (('K3', fused), ('K8 + parts', streamed)):
            got = route(*sets[0])
            rel = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got, want))
            print(f'{what}: Gramian by {name}: max rel err vs the fused twin {rel:.2e}',
                  flush=True)
        t_k3 = chip_smoke.time_ms(torch, fused, sets)
        t_st = chip_smoke.time_ms(torch, streamed, sets)
        t_k8 = chip_smoke.time_ms(torch, lbs_kernels.term1, [(a[0], a[5]) for a in sets])
        print(f'{what}: Gramian (J3={J3}, E={E}, {len(sets)} calls): K3 alone {t_k3:.3f} ms; '
              f'K8 + parts {t_st:.3f} ms (K8 alone {t_k8:.3f} ms) per call on {smi}',
              flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
