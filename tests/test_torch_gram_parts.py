"""K3's two kernels and K15's walk, on the CPU.

K3 (``gram_assembly``) runs on the card as two kernels: term1 = Ksd^T X by
K8's split-K GEMM with 128-row tiles, then the per-column terms and the
ordered sum of term1's split partials. These tests hold, on the CPU:

- that decomposition (``gram_term1_step`` then ``gram_terms_step``, on the
  CPU ``term1_ref`` and ``gram_mparts_ref`` plus the partials' sum), equal
  to ``gram_assembly_ref`` and to the JAX package's ``gram_assembly`` in
  interpret mode, at SMPL E = 10 and 11 (the kid column) and MANO, with and
  without the joints block, on each fitter's own static moments;
- ``lbs_kernels.gram_splits``, K3's split of term1's J3^2 sum, against one
  wave of cards of 132 and 114 SMs;
- K15's walk (``part_sums_bwd``): the part index's 32-vertex tiles, one
  part each, and its ``unused`` rows hold every row below max(V_t, V_a)
  exactly once, on the synthetic SMPL, SMPL-X, SMPL+H and MANO and with
  dense skinning weights; a torch model of the kernel's per-tile arithmetic
  on that walk equals the twin in every form; the wrapper refuses, before
  any launch (``_on_cuda`` patched), a part index that misses a row.
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch

from smplfitter_tpu.ops import lbs_kernels as jax_k
from smplfitter_tpu_torch import BodyFitter
from smplfitter_tpu_torch.ops import lbs_kernels as port_k
from smplfitter_tpu_torch.utils import synthetic

from port_on_cpu import port_model

MODELS = {'smpl': 432, 'smplx': 660, 'smplh16': 432, 'mano': 240}
BATCH = 8
# The JAX kernel splits each f32 product into bf16 parts (about 2^-16
# relative), the twins are plain f32: x max|JAX| per output.
REL_TOL = 1e-5


@pytest.fixture(scope='module')
def models(tmp_path_factory):
    """name -> (BodyModel, BodyFitter) of the synthetic models on the CPU."""
    d = tmp_path_factory.mktemp('gram_parts')
    out = {}
    for name, V in MODELS.items():
        synthetic.write_model_files(str(d), name, V)
        bm = port_model(name, model_root=str(d / name))
        out[name] = (bm, BodyFitter(bm))
    return out


def _rotation_rows(rng, J, batch):
    """R (3, 3J, B): the rows (joint, c) of seeded rotation matrices."""
    q = np.linalg.qr(rng.normal(size=(batch, J, 3, 3)))[0]
    return q.transpose(2, 1, 3, 0).reshape(3, 3 * J, batch)


def _gram_operands(gram, J, has_joints, seed):
    rng = np.random.default_rng(seed)
    E = gram.n_ext
    f32 = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32))  # noqa: E731
    rows = E * J if has_joints else 1
    return (f32(_rotation_rows(rng, J, BATCH)), f32(rng.normal(size=(3, E * J, BATCH))),
            f32(rng.normal(size=(3, J, BATCH))), f32(rng.normal(size=(3, rows, BATCH))),
            f32(rng.normal(size=(3, J if has_joints else 1, BATCH))), gram.Ksd, gram.Lz_e,
            gram.sd1_2d, gram.q, gram.W1_col)


@pytest.mark.parametrize('has_joints', [False, True])
@pytest.mark.parametrize('name, kid', [('smpl', False), ('smpl', True), ('mano', False)])
def test_gram_decomposition_matches_jax(models, name, kid, has_joints):
    bm = models[name][0]
    gram = (BodyFitter(bm, enable_kid=True) if kid else models[name][1]).gram
    J, E = bm.num_joints, gram.n_ext
    assert E == (11 if kid else 10)
    assert not port_k.streams_term1(3 * J, E)  # the model takes K3
    args = _gram_operands(gram, J, has_joints, seed=10 * J + E + has_joints)
    R, T, y, P, bJ, ksd, lz, sd1, q, w1 = args
    part = port_k.gram_term1_step(R, ksd)
    assert torch.equal(part[0], port_k.term1_ref(R, ksd))
    steps = port_k.gram_terms_step(R, T, y, P, bJ, lz, sd1, q, w1, has_joints, part)
    fused = port_k.gram_assembly_ref(*args, has_joints=has_joints)
    theirs = jax_k.gram_assembly(*(a.numpy() for a in args), has_joints=has_joints,
                                 interpret=True)
    for s, f, t in zip(steps, fused, theirs, strict=True):
        t = np.asarray(t)
        assert s.shape == f.shape == t.shape
        assert np.abs(s.numpy() - f.numpy()).max() <= REL_TOL * np.abs(f.numpy()).max()
        assert np.abs(s.numpy() - t).max() <= REL_TOL * np.abs(t).max()


@pytest.mark.parametrize('sms, J3, E, B, want', [
    (132, 72, 10, 4096, 4),    # SMPL: 32 tiles of 128 x 128, four splits fill 128 SMs
    (132, 72, 11, 4096, 4),    # the kid column: E^2 = 121, still one row tile
    (132, 72, 16, 4096, 2),    # two row tiles
    (132, 72, 10, 1000, 16),   # 8 tiles
    (132, 72, 10, 32, 33),     # the online batch: one tile, 4 of the 135 k stages a split
    (132, 48, 10, 32, 15),     # MANO: 60 k stages (6 x 10)
    (132, 72, 10, 256, 33),    # two tiles: 66 would fill the card, 33 keep 4 stages a split
    (132, 72, 10, 16384, 1),   # 128 tiles: one wave without a split
    (132, 72, 10, 65536, 1),   # more tiles than SMs
    (114, 72, 10, 4096, 3),    # a card of 114 SMs
    (114, 72, 10, 32, 33),
    (132, 3, 10, 32, 1),       # one k stage
])
def test_gram_splits_fill_one_wave(monkeypatch, sms, J3, E, B, want):
    monkeypatch.setattr(torch.cuda, 'get_device_properties',
                        lambda device: types.SimpleNamespace(multi_processor_count=sms))
    assert port_k.gram_splits(J3, E * E, B, 'cuda') == want


def _dense_parts(parts, V):
    """The part index of the same membership with every joint active on
    every vertex below V."""
    J = parts.pm.shape[0]
    w = np.random.default_rng(V).uniform(0.01, 1.0, (V, J))
    return port_k.PartIndex.from_membership(parts.pm.numpy(), 'cpu', weights=w)


def _index(models, name, dense):
    bm, fitter = models[name]
    parts = fitter.plan.parts
    return bm.num_vertices, (_dense_parts(parts, bm.num_vertices) if dense else parts)


def _walk_rows(parts, n_rows):
    """The rows K15 writes, as the kernel walks them: each tile's vertices
    below n_rows (with the tile's part, read at its first vertex), then the
    rows in no part below n_rows (zeroed). Returns (rows, parts of rows)."""
    verts, toff = parts.verts.numpy(), parts.tile_offset.numpy()
    vpart = parts.vpart.numpy()
    rows, row_parts = [], []
    for t in range(parts.n_tiles):
        tile = verts[toff[t]:toff[t + 1]]
        p = vpart[tile[0]]
        assert np.all(vpart[tile] == p), f'tile {t} spans parts'
        keep = tile[tile < n_rows]
        rows.extend(keep)
        row_parts.extend([p] * len(keep))
    none = parts.unused.numpy()
    none = none[none < n_rows]
    return np.concatenate([np.asarray(rows, np.int64), none]), \
        np.concatenate([np.asarray(row_parts, np.int64), -np.ones(len(none), np.int64)])


@pytest.mark.parametrize('dense', [False, True])
@pytest.mark.parametrize('name', list(MODELS))
def test_k15_walk_covers_every_row_once(models, name, dense):
    V, parts = _index(models, name, dense)
    vp = parts.pm.shape[1]
    for n_rows in (V, V - 37, vp):
        rows, row_parts = _walk_rows(parts, n_rows)
        assert np.array_equal(np.sort(rows), np.arange(n_rows))
        assert np.array_equal(row_parts, parts.vpart.numpy()[rows])


def _walk_model(graw, gst, gsa, t, a, parts, omega=None):
    """dt, da of K15 on its walk (_walk_rows): per row, the cotangents of the
    row's part (none: zeros), t zero past V_t and a past V_a, ω zero past
    V_t; the summed form's da summed over the batch."""
    v_t, v_a = t.shape[1], a.shape[1]
    B = t.shape[2]
    summed = a.shape[2] == 1 and B > 1
    rows, row_parts = _walk_rows(parts, max(v_t, v_a))
    dt = torch.full((3, v_t, B), float('nan'))
    da = torch.full((3, v_a, 1 if summed else B), float('nan'))
    for v, p in zip(rows.tolist(), row_parts.tolist()):
        if p < 0:
            if v < v_t:
                dt[:, v] = 0.0
            if v < v_a:
                da[:, v] = 0.0
            continue
        wv = 1.0 if omega is None else (omega[v, 0].item() if v < v_t else 0.0)
        tc = t[:, v] if v < v_t else torch.zeros((3, B))
        ad = a[:, v].expand(3, B) if v < v_a else torch.zeros((3, B))
        W = graw[:, p].reshape(3, 3, B)  # W[c, d] = graw[c*3+d, p]
        dtv = gst[:, p] + (W * ad[None]).sum(dim=1)
        dav = (W * tc[:, None]).sum(dim=0)
        if v < v_t:
            dt[:, v] = dtv * wv
        if v < v_a:
            da[:, v] = ((gsa[:, p, 0] + dav.sum(dim=1))[:, None] if summed
                        else gsa[:, p] + dav) * wv
    return dt, da


@pytest.mark.parametrize('omega', [False, True])
@pytest.mark.parametrize('summed', [False, True])
@pytest.mark.parametrize('name', ['smpl', 'mano'])
def test_k15_walk_model_matches_twin(models, name, summed, omega):
    V, parts = _index(models, name, False)
    J, vp = parts.pm.shape
    rng = np.random.default_rng(V + 2 * summed + omega)
    f32 = lambda *shape: torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)  # noqa: E731
    om = None
    if omega:
        om = torch.as_tensor(rng.uniform(0.1, 2.0, (vp, 1)), dtype=torch.float32)
        om[::5] = 0.0
        om[V:] = 0.0
    cols = 1 if summed else BATCH
    for v_t, v_a in ((V, V), (V - 37, V), (V, V - 37)):
        args = (f32(9, J, BATCH), f32(3, J, BATCH), f32(3, J, cols), f32(3, v_t, BATCH),
                f32(3, v_a, cols))
        want = port_k.part_sums_bwd(*args, parts, omega=om)
        got = _walk_model(*args, parts, om)
        for g, w in zip(got, want, strict=True):
            assert g.shape == w.shape
            assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item()


def test_k15_refuses_an_index_missing_a_row(models, monkeypatch):
    V, parts = _index(models, 'smpl', False)
    J, vp = parts.pm.shape
    short = port_k.PartIndex(**{**parts.__dict__, 'unused': parts.unused[1:]})
    monkeypatch.setattr(port_k, '_on_cuda', lambda name, **tensors: True)
    args = (torch.zeros(9, J, 4), torch.zeros(3, J, 4), torch.zeros(3, J, 4),
            torch.zeros(3, V, 4), torch.zeros(3, V, 4))
    with pytest.raises(ValueError, match='each of the'):
        port_k.part_sums_bwd(*args, short)
