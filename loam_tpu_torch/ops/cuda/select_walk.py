"""Greedy selection walk: CUDA kernel wrapper and its plain version
(counterpart of loam_tpu/ops/pallas/select_walk.py).

Contract (both versions): corner_meta/flat_meta (B, R, n_sub*subw)
int32 packed walk metadata in walk order (pack_walk_meta), picked0
(B, R, ceil(W/32)) int64 holding uint32 bit-field words, 1 <= W <=
MAX_W.  Returns (sharp, less_sharp, flat, picked) bit-fields, each
(B, R, ceil(W/32)) int64; the bits past W - 1 of the last word are 0.
A candidate's up and down reaches are each at most MAX_REACH: a pick's
suppression span then covers at most 33 bits, two words of the picked
bit-field, which is what the kernel marks.  corner_k / flat_k cut each
corner / flat walk at that many candidates (config corner_scan_k /
flat_scan_k; 0 or less walks the whole subregion).  The wrapper counts
its kernel launches in ``select_walk.launches``, and in
``select_walk.by_words`` by the words a lane of the kernel instance held
(2, 4 or 8), as the C entry reports.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# ring indices in 13 bits, 8 words a kernel lane (select_walk_max_w);
# here for the configuration check, which runs without the library
MAX_W = 8192
# the largest up or down suppression reach (config suppress_neighbors)
MAX_REACH = 16
# the meta word: bits 0-12 ring index, 13-17 up reach, 18-22 down reach,
# 23 in-span, 24 curvature qualifies
_IND_MASK = (1 << 13) - 1
_REACH_MASK = (1 << 5) - 1
_UP_SHIFT = 13
_DN_SHIFT = 18
_VALID_SHIFT = 23
_QUAL_SHIFT = 24
_ARGTYPES = ((ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 10
             + (ctypes.POINTER(ctypes.c_int), ctypes.c_void_p))


def walk_limit(depth: int, subw: int) -> int:
    """Candidates a walk may visit: the depth knob, else the subregion."""
    return subw if depth <= 0 else min(depth, subw)


def pack_walk_meta(idxc, valid, qual, up_reach, down_reach):
    """Pack per-candidate walk metadata (already in walk order) into int32;
    each reach in [0, MAX_REACH]."""
    return (
        idxc.to(torch.int32)
        | (up_reach.to(torch.int32) << _UP_SHIFT)
        | (down_reach.to(torch.int32) << _DN_SHIFT)
        | (valid.to(torch.int32) << _VALID_SHIFT)
        | (qual.to(torch.int32) << _QUAL_SHIFT)
    )


def unpack_walk_meta(m):
    """The fields of pack_walk_meta: (index, up reach, down reach, valid,
    qual), the last two bool."""
    return (m & _IND_MASK, (m >> _UP_SHIFT) & _REACH_MASK,
            (m >> _DN_SHIFT) & _REACH_MASK,
            ((m >> _VALID_SHIFT) & 1).bool(),
            ((m >> _QUAL_SHIFT) & 1).bool())


def words_for(W: int) -> int:
    """uint32 words of a W-bit bit-field."""
    return -(-W // 32)


def pack_bits(mask):
    """(..., W) bool -> (..., ceil(W/32)) int64 uint32 words (bit b of
    word w = index 32w + b; the tail of the last word 0)."""
    W = mask.shape[-1]
    wb = words_for(W)
    if wb * 32 != W:
        mask = torch.cat([mask, mask.new_zeros(mask.shape[:-1]
                                               + (wb * 32 - W,))], -1)
    m = mask.reshape(mask.shape[:-1] + (wb, 32)).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) << \
        torch.arange(32, device=mask.device)
    return (m * weights).sum(-1)


def unpack_bits(words, W: int):
    """(..., ceil(W/32)) int64 words -> (..., W) bool."""
    shifts = torch.arange(32, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(words.shape[:-1] + (-1,))[..., :W].bool()


def select_walk_plain(corner_meta, flat_meta, picked0, *, n_sub, subw, W,
                      max_sharp, max_less_sharp, max_flat, corner_k=0,
                      flat_k=0):
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
            for t in range(walk_limit(corner_k if corner else flat_k,
                                      subw)):
                ind, up, dn, valid, qual = unpack_walk_meta(
                    meta[:, base + t].long())
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
                max_sharp, max_less_sharp, max_flat, corner_k=0, flat_k=0):
    """Run the walks for B x R rings: the CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    kw = dict(n_sub=n_sub, subw=subw, W=W, max_sharp=max_sharp,
              max_less_sharp=max_less_sharp, max_flat=max_flat,
              corner_k=corner_k, flat_k=flat_k)
    if corner_meta.device.type == "cpu":
        return select_walk_plain(corner_meta, flat_meta, picked0, **kw)
    out, nw = _launch(corner_meta, flat_meta, picked0, **kw)
    select_walk.launches += 1
    select_walk.by_words[nw] = select_walk.by_words.get(nw, 0) + 1
    return out


select_walk.launches = 0
select_walk.by_words = {}   # launches by the instance the C entry reports


def _launch(corner_meta, flat_meta, picked0, *, n_sub, subw, W, max_sharp,
            max_less_sharp, max_flat, corner_k=0, flat_k=0):
    B, R, K = corner_meta.shape
    wb = words_for(W)
    if K != n_sub * subw or not 1 <= W <= MAX_W:
        raise ValueError(f"select_walk: bad shape K={K} W={W} (the kernel "
                         f"takes rings of 1 to {MAX_W} points)")
    _build.require(corner_meta, torch.int32, (B, R, K), "corner_meta")
    _build.require(flat_meta, torch.int32, (B, R, K), "flat_meta")
    _build.require(picked0, torch.int64, (B, R, wb), "picked0")
    out = torch.empty((B, R, 4 * wb), dtype=torch.int64,
                      device=corner_meta.device)
    instance = ctypes.c_int(0)
    launch = _build.entry("select_walk", _ARGTYPES)
    err = launch(*(_build.ptr(t) for t in (corner_meta, flat_meta, picked0,
                                           out)),
                 B, R, n_sub, subw, W, walk_limit(corner_k, subw),
                 walk_limit(flat_k, subw), max_sharp, max_less_sharp,
                 max_flat, ctypes.byref(instance), _build.stream_of(out))
    _build.check(err, "select_walk")
    return (tuple(out[..., f * wb:(f + 1) * wb] for f in range(4)),
            instance.value)
