"""The port's CUDA kernels against their plain PyTorch versions on the card.

These tests need a CUDA device and the CUDA toolkit; elsewhere they skip.
They import no JAX, so on a machine without it run them as

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Each kernel runs through its public wrapper on CUDA tensors with a batch
of two problems of different live sizes (the launch's blockIdx.y axis),
and must equal the plain version on the same tensors: indices and
bit-fields identical, squared distances identical (both compute the
same IEEE sequence round(round(dx^2 + dy^2) + dz^2)).
"""

import dataclasses

import numpy as np
import pytest
import torch

from loam_tpu.config import LoamConfig

from loam_tpu_torch.ops.cuda import knn_topk as KN
from loam_tpu_torch.ops.cuda import odom_corr as OC
from loam_tpu_torch.ops.cuda import select_walk as SW

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _i32(values, dev):
    return torch.tensor(values, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("k", [1, 5])
def test_knn_kernel_matches_plain(cuda, k):
    rng = np.random.default_rng(k)
    B, Q, M, tq, tm = 2, 512, 2048, 128, 256
    ref = torch.tensor(rng.uniform(-4, 4, (B, M, 3)), dtype=torch.float32,
                       device=cuda)
    q = (ref[:, rng.integers(0, 1000, Q)]
         + torch.tensor(rng.normal(0, 0.2, (B, Q, 3)), device=cuda)).float()
    n_q, n_ref = _i32([300, Q], cuda), _i32([1000, 1700], cuda)
    nqb = Q // tq
    t_lo = _i32(rng.integers(0, 3, (B, nqb)), cuda)
    t_hi = _i32(rng.integers(4, M // tm + 1, (B, nqb)), cuda)
    before = KN.knn_topk_dyn.launches
    idx, d2 = KN.knn_topk_dyn(q, ref, n_q, n_ref, k, t_lo, t_hi, tq=tq, tm=tm)
    assert KN.knn_topk_dyn.launches == before + 1
    idx_p, d2_p = KN.knn_topk_plain(q, ref, n_q, n_ref, k, t_lo, t_hi,
                                    tq=tq, tm=tm)
    torch.cuda.synchronize()
    assert torch.equal(idx, idx_p) and torch.equal(d2, d2_p)
    assert (d2[0, 384:] > 1e28).all()          # dead query blocks
    before = KN.knn_topk.launches
    idx, d2 = KN.knn_topk(q, ref, n_ref, k, tq=tq, tm=tm)
    assert KN.knn_topk.launches == before + 1
    full_lo, full_hi = KN.full_windows(B, Q, M, tq, tm, cuda)
    idx_p, d2_p = KN.knn_topk_plain(q, ref, _i32([Q, Q], cuda), n_ref, k,
                                    full_lo, full_hi, tq=tq, tm=tm)
    assert torch.equal(idx, idx_p) and torch.equal(d2, d2_p)


@pytest.mark.parametrize("surf,truncate", [(False, True), (True, True),
                                           (True, False)])
def test_odom_corr_kernel_matches_plain(cuda, surf, truncate):
    rng = np.random.default_rng(7)
    B, Q, M = 2, 256, 2048
    rings = np.sort(rng.integers(0, 16, (B, M)), axis=1)
    ref = torch.tensor(rng.uniform(-10, 10, (B, M, 3)), dtype=torch.float32,
                       device=cuda)
    j1 = _i32(rng.integers(-1, 1500, (B, Q)), cuda)
    q = (torch.gather(ref, 1, j1.clamp(min=0).long()[..., None].expand(
        B, Q, 3)) + torch.tensor(rng.normal(0, 0.3, (B, Q, 3)),
                                 device=cuda)).float().contiguous()
    args = (q, ref, _i32(rings, cuda), j1, _i32([200, Q], cuda),
            _i32([1500, 1800], cuda))
    kw = dict(surf=surf, window=LoamConfig().ring_window, truncate=truncate)
    before = OC.odom_corr.launches
    out = OC.odom_corr(*args, **kw)
    assert OC.odom_corr.launches == before + 1
    plain = OC.odom_corr_plain(*args, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert (out[0] >= 0).sum() > Q


def test_select_walk_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    cfg = dataclasses.replace(LoamConfig(), ring_width=512)
    B, R, W = 2, 16, cfg.ring_width
    n_sub, subw = cfg.n_subregions, W // cfg.n_subregions + 8
    K = n_sub * subw
    order = np.argsort(rng.uniform(size=(B, R, n_sub, subw)), axis=-1)
    base = (np.arange(n_sub) * (W // n_sub))[:, None]
    ind = np.clip(base + order, 0, W - 1).reshape(B, R, K)
    up = rng.integers(0, 6, (B, R, K))
    dn = rng.integers(0, 6, (B, R, K))
    up, dn = np.minimum(up, W - 1 - ind), np.minimum(dn, ind)

    def meta(p_valid, p_qual):
        valid = rng.uniform(size=(B, R, K)) < p_valid
        qual = rng.uniform(size=(B, R, K)) < p_qual
        return SW.pack_walk_meta(*(torch.tensor(a, device=cuda)
                                   for a in (ind, valid, qual, up, dn)))

    cm, fm = meta(0.995, 0.9), meta(0.995, 0.97)
    p0 = SW.pack_bits(torch.tensor(rng.uniform(size=(B, R, W)) < 0.05,
                                   device=cuda))
    kw = dict(n_sub=n_sub, subw=subw, W=W,
              max_sharp=cfg.max_sharp_per_subregion,
              max_less_sharp=cfg.max_less_sharp_per_subregion,
              max_flat=cfg.max_flat_per_subregion)
    before = SW.select_walk.launches
    out = SW.select_walk(cm, fm, p0, **kw)
    assert SW.select_walk.launches == before + 1
    plain = SW.select_walk_plain(cm, fm, p0, **kw)
    torch.cuda.synchronize()
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    assert int(out[0].count_nonzero()) > 0 and int(out[2].count_nonzero()) > 0


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    """A CUDA tensor goes to the kernel or raises; nothing falls back."""
    q = torch.zeros(1, 256, 3, dtype=torch.float64, device=cuda)
    ref = torch.zeros(1, 512, 3, device=cuda)
    with pytest.raises(ValueError, match="float"):
        KN.knn_topk(q, ref, _i32([10], cuda), 1, tq=256, tm=512)
    with pytest.raises(ValueError, match="unsupported k"):
        KN.knn_topk(q.float(), ref, _i32([10], cuda), 3, tq=256, tm=512)
