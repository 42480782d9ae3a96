"""Greedy selection walk: CUDA kernel wrapper and its plain version
(counterpart of loam_tpu/ops/pallas/select_walk.py).

Contract (both versions): corner_meta/flat_meta (B, R, n_sub*subw)
int32 packed walk metadata in walk order (pack_walk_meta), picked0
(B, R, W/32) int64 holding uint32 bit-field words.  Returns
(sharp, less_sharp, flat, picked) bit-fields, each (B, R, W/32) int64.
The wrapper counts its kernel launches in ``select_walk.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

_IND_MASK = (1 << 11) - 1
_UP_SHIFT = 11
_DN_SHIFT = 14
_VALID_SHIFT = 17
_QUAL_SHIFT = 18
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + (ctypes.c_void_p,)


def pack_walk_meta(idxc, valid, qual, up_reach, down_reach):
    """Pack per-candidate walk metadata (already in walk order) into int32."""
    return (
        idxc.to(torch.int32)
        | (up_reach.to(torch.int32) << _UP_SHIFT)
        | (down_reach.to(torch.int32) << _DN_SHIFT)
        | (valid.to(torch.int32) << _VALID_SHIFT)
        | (qual.to(torch.int32) << _QUAL_SHIFT)
    )


def pack_bits(mask):
    """(..., W) bool -> (..., W/32) int64 uint32 words (bit b of word w =
    index 32w + b)."""
    W = mask.shape[-1]
    if W % 32:
        raise ValueError(f"bit-field width {W} is not a multiple of 32")
    m = mask.reshape(mask.shape[:-1] + (W // 32, 32)).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) << \
        torch.arange(32, device=mask.device)
    return (m * weights).sum(-1)


def unpack_bits(words, W: int):
    """(..., W/32) int64 words -> (..., W) bool."""
    shifts = torch.arange(32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (W,)).bool()


def select_walk_plain(corner_meta, flat_meta, picked0, *, n_sub, subw, W,
                      max_sharp, max_less_sharp, max_flat):
    """The same walks as a batched masked loop over walk steps, all rings
    at once; a ring that has stopped stays inert until every ring has."""
    B, R, K = corner_meta.shape
    cm = corner_meta.reshape(B * R, K)
    fm = flat_meta.reshape(B * R, K)
    n = B * R
    dev = cm.device
    picked = unpack_bits(picked0.reshape(n, -1), W)
    fields = [torch.zeros((n, W), dtype=torch.bool, device=dev)
              for _ in range(3)]
    iota = torch.arange(W, device=dev)
    rows = torch.arange(n, device=dev)

    def unpack(m):
        return (m & _IND_MASK, (m >> _UP_SHIFT) & 7, (m >> _DN_SHIFT) & 7,
                ((m >> _VALID_SHIFT) & 1).bool(),
                ((m >> _QUAL_SHIFT) & 1).bool())

    def mark(field, ind, do):
        field[rows, ind] |= do

    def suppress(ind, up, dn, do):
        span = (iota >= (ind - dn)[:, None]) & (iota <= (ind + up)[:, None])
        picked.logical_or_(span & do[:, None])

    for j in range(n_sub):
        base = j * subw
        for corner in (True, False):
            meta = cm if corner else fm
            cnt = torch.zeros(n, dtype=torch.int32, device=dev)
            active = torch.ones(n, dtype=torch.bool, device=dev)
            for t in range(subw):
                ind, up, dn, valid, qual = unpack(meta[:, base + t].long())
                qualify = active & valid & qual & ~picked[rows, ind]
                cnt = cnt + qualify.to(torch.int32)
                if corner:
                    take = qualify & (cnt <= max_less_sharp)
                    mark(fields[0], ind, take & (cnt <= max_sharp))
                    mark(fields[1], ind, take & (cnt > max_sharp))
                    suppress(ind, up, dn, take)
                    stop = (qualify & (cnt > max_less_sharp)) | ~valid | ~qual
                else:
                    mark(fields[2], ind, qualify)
                    suppress(ind, up, dn, qualify & (cnt < max_flat))
                    stop = (qualify & (cnt >= max_flat)) | ~valid | ~qual
                active = active & ~stop
                if not bool(active.any()):
                    break
    outs = [pack_bits(f) for f in fields] + [pack_bits(picked)]
    return tuple(o.reshape(B, R, -1) for o in outs)


def select_walk(corner_meta, flat_meta, picked0, *, n_sub, subw, W,
                max_sharp, max_less_sharp, max_flat):
    """Run the walks for B x R rings: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    kw = dict(n_sub=n_sub, subw=subw, W=W, max_sharp=max_sharp,
              max_less_sharp=max_less_sharp, max_flat=max_flat)
    if corner_meta.device.type == "cpu":
        return select_walk_plain(corner_meta, flat_meta, picked0, **kw)
    out = _launch(corner_meta, flat_meta, picked0, **kw)
    select_walk.launches += 1
    return out


select_walk.launches = 0


def _launch(corner_meta, flat_meta, picked0, *, n_sub, subw, W, max_sharp,
            max_less_sharp, max_flat):
    B, R, K = corner_meta.shape
    wb = W // 32
    if K != n_sub * subw or W % 32 or W > 2048:
        raise ValueError(f"select_walk: bad shape K={K} W={W}")
    _build.require(corner_meta, torch.int32, (B, R, K), "corner_meta")
    _build.require(flat_meta, torch.int32, (B, R, K), "flat_meta")
    p0 = picked0.to(torch.int32).contiguous()   # uint32 bit patterns
    _build.require(p0, torch.int32, (B, R, wb), "picked0")
    out = torch.empty((B, R, 4 * wb), dtype=torch.int32,
                      device=corner_meta.device)
    launch = _build.entry("select_walk", _ARGTYPES)
    err = launch(*(_build.ptr(t) for t in (corner_meta, flat_meta, p0, out)),
                 B, R, n_sub, subw, wb, max_sharp, max_less_sharp, max_flat,
                 _build.stream_of(out))
    _build.check(err, "select_walk")
    words = out.to(torch.int64) & 0xFFFFFFFF
    return tuple(words[..., f * wb:(f + 1) * wb] for f in range(4))
