"""Batch sharding of the port over ``torch.distributed`` (gloo on the CPU).

For each world size (2 and 3) one spawn of that many ranks runs every case
through ``make_sharded_fit_fn`` on the same global batch; the parent runs the
same cases unsharded (no process group: the plain fit). The synthetic SMPL
(V=432), targets with a different shape per instance, made once in the
parent from a numpy seed. Cases: the headline fit at B=8, ``share_beta`` at
B=8, ``share_beta`` at B=7 (padded to the world), and the gradient of a loss
of the B=7 ``share_beta`` fit in the targets. Every rank's outputs (betas,
pose rotation vectors, translation) equal the unsharded fit's within 1e-4,
the gradients within 1e-4 x max|g|. The negative control, the sharded
``share_beta`` fit without ``cross_shard``, differs by more than 1e-3: each
rank then solves the shape of its own slice only.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import smplfitter_tpu_torch
from smplfitter_tpu_torch.parallel import padded_global_batch, sharding
from smplfitter_tpu_torch.utils import synthetic

WORLD_SIZES = (2, 3)
ATOL = 1e-4
GRAD_REL = 1e-4
CONTROL_MIN = 1e-3
KEYS = ('shape_betas', 'pose_rotvecs', 'trans')
FIT_KW = dict(num_iter=2, beta_regularizer=0.5, final_adjust_rots=True, requested_keys=KEYS)
# case -> (batch, share_beta, cross_shard)
CASES = {
    'headline': (8, False, True),
    'share_beta': (8, True, True),
    'share_beta_b7': (7, True, True),
    'share_beta_grad': (7, True, True),
    'no_cross_shard': (8, True, False),
}


def _run_cases(model_root: str, targets: dict) -> dict:
    """{f'{case}/{key}': array} of every case through make_sharded_fit_fn
    (the plain fit where no process group is initialized)."""
    bm = smplfitter_tpu_torch.BodyModel('smpl', 'neutral', model_root, device='cpu')
    fitter = smplfitter_tpu_torch.BodyFitter(bm)
    out = {}
    for case, (batch, share, cross) in CASES.items():
        tv = torch.as_tensor(targets['tv'][:batch])
        tj = torch.as_tensor(targets['tj'][:batch])
        fit = sharding.make_sharded_fit_fn(fitter, share_beta=share, **FIT_KW)
        region = sharding.cross_shard
        if not cross:
            sharding.cross_shard = lambda group=None: contextlib.nullcontext()
        try:
            if case.endswith('_grad'):
                tv, tj = tv.requires_grad_(), tj.requires_grad_()
                res = fit(tv, tj)
                loss = sum((res[k] ** 2).sum() for k in KEYS)
                g_tv, g_tj = torch.autograd.grad(loss, (tv, tj))
                res = dict(res, g_tv=g_tv, g_tj=g_tj)
            else:
                res = fit(tv, tj)
        finally:
            sharding.cross_shard = region
        for key, value in res.items():
            out[f'{case}/{key}'] = value.detach().numpy()
    return out


def _worker(rank: int, world: int, init_file: str, model_root: str, work_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group('gloo', init_method=f'file://{init_file}', rank=rank,
                            world_size=world)
    try:
        targets = dict(np.load(os.path.join(work_dir, 'targets.npz')))
        out = _run_cases(model_root, targets)
        batch = len(targets['tv']) // world * world
        tree = sharding.shard_batch({'tv': torch.as_tensor(targets['tv'][:batch]),
                                     'ids': [np.arange(batch), 7]})
        out.update({'shard/tv': tree['tv'].numpy(), 'shard/ids': tree['ids'][0],
                    'shard/scalar': np.asarray(tree['ids'][1])})
        np.savez(os.path.join(work_dir, f'rank{rank}.npz'), **out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    d = str(tmp_path_factory.mktemp('sharding'))
    synthetic.write_model_files(d, 'smpl', 432)
    model_root = os.path.join(d, 'smpl')
    bm = smplfitter_tpu_torch.BodyModel('smpl', 'neutral', model_root, device='cpu')
    rng = np.random.default_rng(16)
    batch = max(b for b, _, _ in CASES.values())
    pose = rng.normal(0, 0.2, (batch, 72)).astype(np.float32)
    betas = rng.normal(0, 1, (batch, 10)).astype(np.float32)
    trans = rng.normal(0, 0.5, (batch, 3)).astype(np.float32)
    with torch.no_grad():
        res = bm(pose_rotvecs=pose, shape_betas=betas, trans=trans)
    targets = dict(tv=res['vertices'].numpy(), tj=res['joints'].numpy())
    np.savez(os.path.join(d, 'targets.npz'), **targets)
    return d, model_root, _run_cases(model_root, targets)


@pytest.fixture(scope='module', params=WORLD_SIZES)
def sharded(request, setup):
    """Every rank's results of one spawn of ``world`` ranks."""
    d, model_root, _ = setup
    world = request.param
    work_dir = os.path.join(d, f'world{world}')
    os.makedirs(work_dir)
    os.link(os.path.join(d, 'targets.npz'), os.path.join(work_dir, 'targets.npz'))
    mp.start_processes(_worker, args=(world, os.path.join(work_dir, 'store'), model_root,
                                      work_dir), nprocs=world, start_method='spawn')
    return [dict(np.load(os.path.join(work_dir, f'rank{r}.npz'))) for r in range(world)]


@pytest.mark.parametrize('case', [c for c in CASES if c != 'no_cross_shard'])
def test_sharded_fit_equals_unsharded(setup, sharded, case):
    plain = setup[2]
    for rank, res in enumerate(sharded):
        for key in KEYS:
            want = plain[f'{case}/{key}']
            got = res[f'{case}/{key}']
            assert got.shape == want.shape, (rank, key)
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=f'rank {rank} {key}')
        if CASES[case][1]:
            assert float(np.std(res[f'{case}/shape_betas'], axis=0).max()) < 1e-5
        for key in ('g_tv', 'g_tj'):
            if f'{case}/{key}' in plain:
                want = plain[f'{case}/{key}']
                np.testing.assert_allclose(res[f'{case}/{key}'], want, rtol=0,
                                           atol=GRAD_REL * np.abs(want).max(),
                                           err_msg=f'rank {rank} {key}')


def test_sharded_share_beta_needs_cross_shard(setup, sharded):
    plain = setup[2]
    gaps = [np.abs(res['no_cross_shard/shape_betas'] - plain['no_cross_shard/shape_betas']).max()
            for res in sharded]
    assert min(gaps) > CONTROL_MIN, gaps


def test_shard_batch_takes_each_rank_its_slice(sharded):
    world = len(sharded)
    for rank, res in enumerate(sharded):
        per = len(res['shard/ids'])
        np.testing.assert_array_equal(res['shard/ids'], np.arange(rank * per, (rank + 1) * per))
        assert per == max(b for b, _, _ in CASES.values()) // world
        assert res['shard/tv'].shape[0] == per and int(res['shard/scalar']) == 7


@pytest.mark.parametrize('batch, world, want', [(8, 2, 8), (7, 2, 8), (7, 3, 9), (8, 3, 9),
                                                (1, 3, 3)])
def test_padded_global_batch(batch, world, want):
    assert padded_global_batch(batch, world) == want
