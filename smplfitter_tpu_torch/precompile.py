"""Pay the port's first-use costs once, before a production process does.

Usage: ``python -m smplfitter_tpu_torch.precompile [--batch-sizes 32 1024 4096 ...]``

The first use of the port on the card pays for: the nvcc build of the kernels
(``ops/_build.py``, kept in ``smplfitter_tpu_torch/_build/<hash>/`` and
reused by every later process of the same source tree), each model's host
precompute (the vertex covers, part index and Gramian data of ``BodyModel``
and ``BodyFitter``), and the first fit. :func:`warm` runs them in that order
and prints the seconds of each step: the kernel library, the model and its
fitter, one forward pass and one fit per batch size (and the fit without
target joints where ``with_joints`` is off), optionally the value and
gradient of the fit per batch size (``--grad``) and the kernels-against-twins
check (``--check-parity``, which exits nonzero on a failure).

The JAX package's ``--cache-dir`` has no counterpart: the kernel library is
found only under ``_build/``, so a build elsewhere would warm nothing. The
model's host precompute lives in the process and is not cached on disk.
"""

from __future__ import annotations

import argparse
import os
import time


def _step(what: str, t0: float) -> None:
    print(f'  {what}: {time.perf_counter() - t0:.2f} s', flush=True)


def warm(
    model_name: str = 'smpl',
    gender: str = 'neutral',
    model_root: str | None = None,
    batch_sizes=(32, 1024, 4096),
    num_iter: int = 3,
    num_betas: int = 10,
    with_joints: bool = True,
    synthetic_fallback: bool = False,
    grad_chunk: int | None = 0,
    check_parity: bool = False,
    device='cuda',
) -> None:
    """Build the kernels (on a CUDA ``device``), the model and its fitter, and
    run a forward pass and a fit per batch size; see the module docstring.
    ``synthetic_fallback`` without a ``model_root`` loads the synthetic models
    at full width with the applications' assets, written once under
    ``smplfitter_tpu_torch/_build/body_models`` (where ``chip_smoke.py`` keeps them).
    ``grad_chunk``: 0 skips the gradient, None warms ``get_fit_grad_fn``
    unchunked, an integer chunked (batches below it or not a multiple of it
    are skipped). ``device='cuda'`` without a CUDA device raises, as
    ``BodyModel`` does."""
    import numpy as np
    import torch

    import smplfitter_tpu_torch as port
    from smplfitter_tpu_torch.models.bodymodel import _model_device
    from smplfitter_tpu_torch.ops import _build

    device = _model_device(device)
    if device.type == 'cuda':
        t0 = time.perf_counter()
        _build.library()
        _step('kernel library (nvcc build or cached)', t0)

    if synthetic_fallback and model_root is None:
        from smplfitter_tpu_torch.utils import synthetic

        t0 = time.perf_counter()
        models_dir = os.path.join(_build.BUILD_ROOT, 'body_models')
        model_root = os.path.join(synthetic.ensure_cached_models(models_dir, full=True),
                                  model_name)
        _step('synthetic models', t0)

    t0 = time.perf_counter()
    bm = port.BodyModel(model_name, gender, model_root, num_betas=num_betas, device=device)
    fitter = port.BodyFitter(bm)
    _step(f'{model_name} model and fitter', t0)

    def sync():
        if device.type == 'cuda':
            torch.cuda.synchronize(device)

    kw = dict(num_iter=num_iter, final_adjust_rots=True,
              requested_keys=('pose_rotvecs', 'shape_betas', 'trans'))
    rng = np.random.default_rng(0)

    def targets(batch):
        pose = rng.normal(0, 0.2, (batch, bm.num_joints * 3)).astype(np.float32)
        betas = rng.normal(0, 1, (batch, num_betas)).astype(np.float32)
        with torch.no_grad():
            return bm(pose_rotvecs=pose, shape_betas=betas)

    for batch in batch_sizes:
        t0 = time.perf_counter()
        res = targets(batch)
        with torch.no_grad():
            fitter.fit(res['vertices'], res['joints'], **kw)
            if not with_joints:
                fitter.fit(res['vertices'], **kw)
        sync()
        _step(f'batch {batch}: forward and fit', t0)

    if grad_chunk != 0:
        vg = port.get_fit_grad_fn(fitter, chunk=grad_chunk, num_iter=num_iter)
        for batch in batch_sizes:
            if grad_chunk and (batch < grad_chunk or batch % grad_chunk):
                continue
            res = targets(batch)
            t0 = time.perf_counter()
            vg(res['vertices'], res['joints'])
            sync()
            _step(f'grad batch {batch} (chunk {grad_chunk})', t0)

    if check_parity:
        t0 = time.perf_counter()
        rep = fitter.check_kernel_parity(num_iter=num_iter)
        _step(f'kernel parity: ok={rep["ok"]} max|d betas|={rep["max_dbetas"]:.2e} '
              f'v2v kernels={rep["v2v_kernel_mm"]:.4f} mm CPU twins={rep["v2v_xla_mm"]:.4f} mm',
              t0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--model', default='smpl')
    parser.add_argument('--gender', default='neutral')
    parser.add_argument('--model-root', default=None)
    parser.add_argument('--batch-sizes', nargs='*', type=int, default=[32, 1024, 4096])
    parser.add_argument('--num-iter', type=int, default=3)
    parser.add_argument('--num-betas', type=int, default=10)
    parser.add_argument('--synthetic', action='store_true',
                        help='use synthetic model files at full width (benchmarking without '
                             'licensed data)')
    parser.add_argument('--grad', type=int, nargs='?', const=-1, default=0, metavar='CHUNK',
                        help='also run the value and gradient of the fit: bare --grad '
                             'unchunked, --grad N in chunks of N instances (the '
                             'memory-bounded recipe)')
    parser.add_argument('--check-parity', action='store_true',
                        help='run BodyFitter.check_kernel_parity() after warming: one batch '
                             'through the kernels against the plain twins on the CPU '
                             '(exits nonzero on failure)')
    args = parser.parse_args(argv)
    warm(
        args.model,
        args.gender,
        args.model_root,
        tuple(args.batch_sizes),
        args.num_iter,
        args.num_betas,
        synthetic_fallback=args.synthetic,
        grad_chunk=None if args.grad == -1 else args.grad,
        check_parity=args.check_parity,
    )
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
