"""Row (tensor) parallelism of the normal equations (counterpart of
loam_tpu/parallel/context.py).

The JAX package annotates the Jacobian row axis with a PartitionSpec and
lets GSPMD insert the psum of the JtJ / Jtb contraction.  PyTorch has no
GSPMD: here the ranks of a tp process group each keep a contiguous block
of the row axis (constrain_rows / constrain_axis0), form their partial
6x6 / 6x1 sums, and reduce_rows adds them with one explicit all_reduce.

The group reaches the inner ``residuals.normal_equations`` call through
a context variable, so the single-card path makes no call and stays
bit-identical.  The row axis is the one after the leading scenario axis.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

_ROW_GROUP: contextvars.ContextVar = contextvars.ContextVar(
    "loam_row_group", default=None
)


@contextlib.contextmanager
def row_sharding(group):
    """Within this context the Jacobian rows are split over the ranks of
    `group` (a torch.distributed process group, the mesh's tp group);
    None leaves them whole."""
    token = _ROW_GROUP.set(group)
    try:
        yield
    finally:
        _ROW_GROUP.reset(token)


def _block(x):
    group = _ROW_GROUP.get()
    if group is None:
        return x
    tp = dist.get_world_size(group)
    return torch.tensor_split(x, tp, dim=1)[dist.get_rank(group)]


def constrain_rows(rows):
    """This rank's contiguous block of the row axis of rows (B, N, ...),
    or rows itself outside row_sharding."""
    return _block(rows)


def constrain_axis0(x):
    """The same block for the accumulated normal equations' (B, N, 3, 6),
    (B, N, 3, 3) and (B, N, 3) point blocks: the scenario axis leads, so
    the point axis is axis 1 here as for constrain_rows."""
    return _block(x)


def reduce_rows(*tensors):
    """The partial sums of every rank of the row group added, with one
    all_reduce on the tensors concatenated; outside row_sharding the
    tensors themselves.  Every rank gets the same bits back, so the
    solves, the host reads of convergence flags and the mapping cadence
    that follow stay in lockstep across the group: no rank takes a
    branch the others do not, which is what keeps the next all_reduce
    from deadlocking."""
    group = _ROW_GROUP.get()
    if group is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return tuple(out)
