#!/usr/bin/env python3
"""Drive the PyTorch port (smplfitter_tpu_torch) once on an NVIDIA GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine with
one CUDA device, nvcc and PyTorch built for CUDA. It builds the kernels from
``smplfitter_tpu_torch/csrc``, then, on a synthetic SMPL model at full width
(V=6890, J=24, 10 betas, kid shapedir; weights random from a seed):

 1. prints the toolchain (torch, CUDA, device, power limit, nvcc);
 2. builds the kernels and prints the build time;
 3. runs every kernel against its plain PyTorch twin on the operands the
    fitting paths give it (captured during forward passes, the benchmark fit
    and paths a-e below) at B=4096 and at a ragged B=1000, and times both;
 4. makes 8 distinct target sets with ``BodyModel`` at B=4096;
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
    of phase 6.

It prints a JSON line of per-kernel results, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero; without a CUDA device it exits non-zero before doing anything.
"""

from __future__ import annotations

import json
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
KERNEL_REL_TOL = 1e-5  # max |kernel - twin| / max |twin|, per output
PARITY_DBETA = 1e-3
PARITY_V2V_MM = 0.01

# LAUNCHES key -> (wrapper, CUDA source, TPU kernel replaced, output names). The
# two K2 forms without the posed template share the wrapper rhs_moments (its
# ``scale`` argument picks the form).
KERNELS = {
    'lbs_points': ('lbs_points', 'smplfitter_tpu_torch/csrc/lbs_points.cu',
                   'smplfitter_tpu/ops/lbs_kernels.py:771', ('points',)),
    'rhs_moments_h': ('rhs_moments_h', 'smplfitter_tpu_torch/csrc/rhs_moments.cu',
                      'smplfitter_tpu/ops/lbs_kernels.py:525', ('r', 'y', 'homog')),
    'rhs_moments': ('rhs_moments', 'smplfitter_tpu_torch/csrc/rhs_moments.cu',
                    'smplfitter_tpu/ops/lbs_kernels.py:525', ('r', 'y')),
    'rhs_moments_scale': ('rhs_moments', 'smplfitter_tpu_torch/csrc/rhs_moments.cu',
                          'smplfitter_tpu/ops/lbs_kernels.py:525',
                          ('r', 'y', 'rt', 'yt', 'sc')),
    'gram_assembly': ('gram_assembly', 'smplfitter_tpu_torch/csrc/gram_assembly.cu',
                      'smplfitter_tpu/ops/lbs_kernels.py:1819', ('G', 'SA', 'rb', 'Sb')),
    'recon_part_sums_cached': ('recon_part_sums_cached_lm',
                               'smplfitter_tpu_torch/csrc/recon_part_sums.cu',
                               'smplfitter_tpu/ops/lbs_kernels.py:2808',
                               ('raw', 's_t', 's_a')),
    'part_sums': ('part_sums_vm_lm', 'smplfitter_tpu_torch/csrc/part_sums.cu',
                  'smplfitter_tpu/ops/lbs_kernels.py:832', ('raw', 's_t', 's_a')),
    'recon_part_sums': ('recon_part_sums_lm', 'smplfitter_tpu_torch/csrc/recon_lbs_part_sums.cu',
                        'smplfitter_tpu/ops/lbs_kernels.py:1365', ('raw', 's_t', 's_a')),
}
WRAPPERS = sorted({spec[0] for spec in KERNELS.values()})

# The other fitting paths (phases 7 and 8): the call on (fitter, fitter_kid,
# targets, params) and the kernel launches of one call, from the code.
FLIP_KW = dict(num_iter=1, beta_regularizer=1e-2, beta_regularizer2=1e-2, kid_regularizer=1e9,
               final_adjust_rots=True, requested_keys=('pose_rotvecs',))
PATHS = {
    'a_fit_no_joints': dict(
        run=lambda f, fk, tv, tj, p: f.fit(tv, num_iter=3, final_adjust_rots=True,
                                           requested_keys=('pose_rotvecs', 'vertices')),
        launches=dict(rhs_moments=3, gram_assembly=3, part_sums=3, lbs_points=4)),
    'b_flipper': dict(
        run=lambda f, fk, tv, tj, p: fk.fit(tv, initial_pose_rotvecs=p[0] + 0.05,
                                            initial_shape_betas=p[1] + 0.1,
                                            initial_kid_factor=p[3] + 0.1, **FLIP_KW),
        launches=dict(rhs_moments=1, gram_assembly=1, part_sums=2, lbs_points=2)),
    'c_known_shape': dict(
        run=lambda f, fk, tv, tj, p: f.fit_with_known_shape(p[1], tv, tj, num_iter=3,
                                                            final_adjust_rots=True),
        launches=dict(recon_part_sums=4)),
    'd_known_pose': dict(
        run=lambda f, fk, tv, tj, p: f.fit_with_known_pose(p[0], tv),
        launches=dict(rhs_moments=1, gram_assembly=1)),
    'e_scale_fit': dict(
        run=lambda f, fk, tv, tj, p: f.fit(tv, tj, num_iter=3, scale_fit=True,
                                           final_adjust_rots=True),
        launches=dict(rhs_moments_h=2, rhs_moments_scale=1, gram_assembly=3,
                      recon_part_sums_cached=2, recon_part_sums=1)),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def random_params(rng, batch):
    pose = rng.normal(0, 0.3, (batch, 72)).astype(np.float32)
    betas = rng.normal(0, 1, (batch, 10)).astype(np.float32)
    trans = rng.normal(0, 0.5, (batch, 3)).astype(np.float32)
    return pose, betas, trans


def kid_factors(rng, batch):
    return rng.normal(0, 0.5, (batch,)).astype(np.float32)


def capture_kernel_calls(lbs_kernels, run) -> dict:
    """Run ``run()`` with every kernel wrapper recording its arguments, by
    LAUNCHES key."""
    calls = {key: [] for key in KERNELS}
    originals = {name: getattr(lbs_kernels, name) for name in WRAPPERS}

    key_of = {spec[0]: key for key, spec in KERNELS.items() if key != 'rhs_moments_scale'}

    def recorder(name, fn):
        def wrapped(*args, **kwargs):
            key = 'rhs_moments_scale' if kwargs.get('scale') else key_of[name]
            calls[key].append((args, kwargs))
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


def kernel_call(lbs_kernels, key, args, kwargs):
    out = getattr(lbs_kernels, KERNELS[key][0])(*args, **kwargs)
    return out if isinstance(out, tuple) else (out,)


def twin_call(lbs_kernels, key, args, kwargs):
    return lbs_kernels.twin_call(KERNELS[key][0], args, kwargs)


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 1

    import smplfitter_tpu_torch as port
    from smplfitter_tpu_torch.ops import _build, lbs_kernels
    from smplfitter_tpu_torch.utils import synthetic

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

    # 3. Kernels against their twins on the fitting paths' operands.
    log('== phase 3: kernels vs plain twins (synthetic SMPL, V=6890)')
    models_dir = synthetic.ensure_cached_models()
    bm = port.BodyModel('smpl', 'neutral', model_root=models_dir + '/smpl', device=dev)
    fitter = port.BodyFitter(bm)
    fitter_kid = port.BodyFitter(bm, enable_kid=True)
    results = {key: dict(max_abs_err=0.0, rel_err={out: 0.0 for out in spec[3]})
               for key, spec in KERNELS.items()}
    for batch in (BATCH, RAGGED_BATCH):
        params = [random_params(rng, batch) for _ in range(3)]
        kid = torch.as_tensor(kid_factors(kid_rng, batch), device=dev)

        def run():
            for p in params:
                out = bm(*p)
            tv, tj = out['vertices'], out['joints']
            fitter.fit(tv, tj, **FIT_KW)
            p = tuple(torch.as_tensor(x, device=dev) for x in params[-1]) + (kid,)
            for path in PATHS.values():
                path['run'](fitter, fitter_kid, tv, tj, p)

        calls = capture_kernel_calls(lbs_kernels, run)
        for key, arg_sets in calls.items():
            if not arg_sets:
                raise AssertionError(f'{key}: no call captured at B={batch}')
            outputs = KERNELS[key][3]
            for args, kwargs in arg_sets:
                got = kernel_call(lbs_kernels, key, args, kwargs)
                want = twin_call(lbs_kernels, key, args, kwargs)
                torch.cuda.synchronize()
                for out_name, g, w in zip(outputs, got, want, strict=True):
                    abs_err = (g - w).abs().max().item()
                    scale = w.abs().max().item()
                    rel = abs_err / scale if scale > 0 else abs_err
                    if not (rel <= KERNEL_REL_TOL and torch.isfinite(g).all().item()):
                        raise AssertionError(
                            f'{key}.{out_name} at B={batch}: max|kernel - twin| = {abs_err:.3e}'
                            f' = {rel:.3e} x max|twin| > {KERNEL_REL_TOL}')
                    res = results[key]
                    res['max_abs_err'] = max(res['max_abs_err'], abs_err)
                    res['rel_err'][out_name] = max(res['rel_err'][out_name], rel)
            # Timed over the calls of the first call's configuration (same
            # keyword arguments and operand shapes).
            args0, kw = arg_sets[0]
            shapes0 = [getattr(a, 'shape', None) for a in args0]
            sets = [args for args, kwargs in arg_sets
                    if kwargs == kw and [getattr(a, 'shape', None) for a in args] == shapes0]
            errs = ' '.join(f'{k} {v:.2e}' for k, v in results[key]['rel_err'].items())
            line = f'{key:24s} B={batch:5d} calls={len(arg_sets)} max rel err: {errs}'
            if batch == BATCH:
                results[key]['ms'] = time_ms(
                    torch, lambda *a: kernel_call(lbs_kernels, key, a, kw), sets)
                results[key]['plain_ms'] = time_ms(
                    torch, lambda *a: twin_call(lbs_kernels, key, a, kw), sets)
                line += (f'  kernel {results[key]["ms"]:.3f} ms  '
                         f'twin {results[key]["plain_ms"]:.3f} ms')
            log(line)
        del calls
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
    if fwd_launches < 1:
        raise AssertionError('the forward pass did not launch lbs_points')
    log(f'forward: {N_TARGETS} x B={BATCH} in {fwd_s * 1e3:.1f} ms, lbs_points launches '
        f'{fwd_launches}')

    log(f'== phase 5: fit, B={BATCH}, {N_TARGETS} distinct target sets')
    fitter.fit(*targets[0], **FIT_KW)  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    fits = [fitter.fit(tv, tj, **FIT_KW) for tv, tj in targets]
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    fit_ms = start.elapsed_time(end)
    launches = dict(lbs_kernels.LAUNCHES)
    n_fits = N_TARGETS + 1
    check_launches(dict(launches, lbs_points=launches['lbs_points'] - fwd_launches),
                   dict(rhs_moments_h=3, gram_assembly=3, recon_part_sums_cached=3),
                   n_fits, 'phase 5')
    shapes = dict(pose_rotvecs=(BATCH, 72), shape_betas=(BATCH, 10), trans=(BATCH, 3))
    for res in fits:
        for key, shape in shapes.items():
            if tuple(res[key].shape) != shape or not torch.isfinite(res[key]).all():
                raise AssertionError(f'fit output {key}: shape {tuple(res[key].shape)}, '
                                     f'expected {shape}, or not finite')
    fits_per_s = N_TARGETS * BATCH / (fit_ms / 1e3)
    log(f'launches in the main path: {json.dumps(launches)}')
    log(f'fit throughput: {fits_per_s:.1f} fits/s (B={BATCH}, {N_TARGETS} fits, '
        f'{fit_ms / N_TARGETS:.2f} ms/fit on CUDA events, {host_s / N_TARGETS * 1e3:.2f} ms/fit '
        f'host) on {smi}')
    refit = bm(fits[-1]['pose_rotvecs'], fits[-1]['shape_betas'], fits[-1]['trans'])
    v2v_mm = (refit['vertices'] - targets[-1][0]).norm(dim=-1).mean().item() * 1e3
    if not np.isfinite(v2v_mm):
        raise AssertionError('round-trip reconstruction is not finite')
    log(f'round-trip mean v2v: {v2v_mm:.4f} mm')
    del fits, refit
    torch.cuda.empty_cache()
    total_launches = dict(launches)

    # 6. Card against the CPU twins at B=32.
    log(f'== phase 6: parity, B={PARITY_BATCH}, card vs CPU')
    pose, betas, trans = (torch.as_tensor(x, device=dev)
                          for x in random_params(rng, PARITY_BATCH))
    out = bm(pose, betas, trans)
    tv, tj = out['vertices'].contiguous(), out['joints']
    gpu = fitter.fit(tv, tj, **FIT_KW)
    cpu_bm = port.BodyModel.from_model_data(bm.model_data, device='cpu')
    cpu_fitter = port.BodyFitter(cpu_bm)
    cpu = cpu_fitter.fit(tv.cpu(), tj.cpu(), **FIT_KW)
    max_dbeta = (gpu['shape_betas'].cpu() - cpu['shape_betas']).abs().max().item()
    v2v_gpu, v2v_cpu = recon_v2v_mm(bm, gpu, tv), recon_v2v_mm(bm, cpu, tv)
    ok = max_dbeta <= PARITY_DBETA and abs(v2v_gpu - v2v_cpu) <= PARITY_V2V_MM
    log(f'parity: ok={ok} max|dbeta|={max_dbeta:.3e} v2v card={v2v_gpu:.4f} mm '
        f'cpu={v2v_cpu:.4f} mm')
    if not ok:
        raise AssertionError('card fit disagrees with the CPU fit')

    # 7. The other fitting paths on the same target sets.
    kids = [torch.as_tensor(kid_factors(kid_rng, BATCH), device=dev) for _ in range(N_TARGETS)]
    for name, path in PATHS.items():
        log(f'== phase 7{name[0]}: {name}, B={BATCH}, {N_TARGETS} distinct target sets')
        lbs_kernels.reset_launch_counts()
        path['run'](fitter, fitter_kid, *targets[0], inputs[0] + (kids[0],))  # warm-up
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        fits = [path['run'](fitter, fitter_kid, tv, tj, p + (k,))
                for (tv, tj), p, k in zip(targets, inputs, kids)]
        end.record()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        path_ms = start.elapsed_time(end)
        launches = dict(lbs_kernels.LAUNCHES)
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
    unlaunched = [key for key, n in total_launches.items() if n == 0]
    if unlaunched:
        raise AssertionError(f'kernels never launched on the fitting paths: {unlaunched}')

    # 8. Each other path on the card against the CPU twins at B=32.
    log(f'== phase 8: parity of paths a-e, B={PARITY_BATCH}, card vs CPU')
    cpu_fitter_kid = port.BodyFitter(cpu_bm, enable_kid=True)
    params = tuple(torch.as_tensor(x, device=dev) for x in random_params(rng, PARITY_BATCH))
    params += (torch.as_tensor(kid_factors(kid_rng, PARITY_BATCH), device=dev),)
    out = bm(*params)
    tv, tj = out['vertices'].contiguous(), out['joints'].contiguous()
    for name, path in PATHS.items():
        gpu = path['run'](fitter, fitter_kid, tv, tj, params)
        cpu = path['run'](cpu_fitter, cpu_fitter_kid, tv.cpu(), tj.cpu(),
                          tuple(x.cpu() for x in params))
        max_d = max((gpu[k].cpu() - cpu[k]).abs().max().item()
                    for k in ('shape_betas', 'kid_factor', 'scale_corr') if k in gpu)
        v2v_gpu, v2v_cpu = recon_v2v_mm(bm, gpu, tv), recon_v2v_mm(bm, cpu, tv)
        ok = max_d <= PARITY_DBETA and abs(v2v_gpu - v2v_cpu) <= PARITY_V2V_MM
        log(f'{name}: ok={ok} max|d betas, kid, scale|={max_d:.3e} v2v card={v2v_gpu:.4f} mm '
            f'cpu={v2v_cpu:.4f} mm')
        if not ok:
            raise AssertionError(f'{name}: card disagrees with the CPU')

    kernels = []
    for key, (_, source, replaces, _) in KERNELS.items():
        r = results[key]
        kernels.append(dict(name=key, route='cuda', source=source, replaces=replaces,
                            launches=total_launches[key], max_abs_err=r['max_abs_err'],
                            ms=r['ms'], plain_ms=r['plain_ms']))
    print(json.dumps(dict(kernels=kernels)), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps(dict(ok=True, device=dict(platform='gpu', kind=card,
                                               count=torch.cuda.device_count()))), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
