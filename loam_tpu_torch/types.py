"""Core tensor containers (counterpart of loam_tpu/types.py).

Fixed-capacity struct-of-arrays with an explicit validity mask.  Any
leading axes (frames, scenarios) ride in front of the point axis.
tree_map and where_tree act on any dataclass of tensors (states,
outputs), the port's stand-in for jax.tree_util.
"""

from __future__ import annotations

import dataclasses

import torch


def _map_fields(obj, fn):
    return dataclasses.replace(
        obj, **{f.name: fn(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    )


def tree_map(fn, obj, *rest):
    """fn over the tensors of nested dataclasses and tuples (None stays
    None); the trees in `rest` have obj's structure and give fn further
    arguments."""
    if obj is None:
        return None
    if isinstance(obj, tuple):
        return tuple(tree_map(fn, *parts) for parts in zip(obj, *rest))
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: tree_map(fn, getattr(obj, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(obj)})
    return fn(obj, *rest)


def add_scenario_axis(tree):
    """One scenario's tree as a batch of one (a leading axis of 1)."""
    return tree_map(lambda t: t[None], tree)


def drop_scenario_axis(tree):
    """A batch of one back to its one scenario."""
    return tree_map(lambda t: t[0], tree)


def per_scenario(fn, *args):
    """fn one scenario at a time: args are trees with a leading B axis
    (args[0] a tensor), each call gets scenario b's slices, and the
    results (tensors, tuples or dataclasses of them) are stacked into a
    leading B axis again.  For the few small products and sums whose
    rounding depends on how many scenarios ride along: on the card
    cuBLAS and the reduction kernels choose their algorithm, and so the
    order of their additions, from the batched shape, and on the CPU a
    batched matrix times one column rounds otherwise than a single one.
    A scenario's numbers must not depend on its neighbours."""
    outs = [fn(*(tree_map(lambda t: t[b], a) for a in args))
            for b in range(args[0].shape[0])]
    return tree_map(lambda *ts: torch.stack(ts), *outs)


def where_tree(cond, a, b):
    """Per scenario: a where cond (B,) holds, else b (trees with a
    leading B axis on every tensor)."""
    return tree_map(lambda x, y: torch.where(
        cond.reshape(cond.shape + (1,) * (x.dim() - 1)), x, y), a, b)


@dataclasses.dataclass
class PointCloud:
    """xyz (..., N, 3) float32 internal frame; rel (..., N) the
    ring + scanPeriod*relTime channel; mask (..., N) bool."""

    xyz: torch.Tensor
    rel: torch.Tensor
    mask: torch.Tensor

    @staticmethod
    def zeros(n: int, device=None, lead: tuple = ()) -> "PointCloud":
        """An empty cloud of capacity n with leading axes `lead`."""
        return PointCloud(
            xyz=torch.zeros(lead + (n, 3), dtype=torch.float32,
                            device=device),
            rel=torch.zeros(lead + (n,), dtype=torch.float32, device=device),
            mask=torch.zeros(lead + (n,), dtype=torch.bool, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return self.mask.sum(-1, dtype=torch.int32)

    def ring(self) -> torch.Tensor:
        """Integer ring id with C truncation (not floor), as int(rel)."""
        return torch.trunc(self.rel).to(torch.int32)

    def sweep_time(self, scan_period: float) -> torch.Tensor:
        """The point's fraction of the sweep, s = (rel - trunc(rel)) /
        scan_period: the frontend encodes rel = ring + scan_period *
        rel_time, so s is rel_time at any rotation rate.

        src/laserOdometry.cpp:103 and loam_tpu hard-code s = 10 * frac,
        the inverse of the C++'s fixed scanPeriod of 0.1 s; at another
        period that deskews each point by 10 * scan_period * rel_time of
        the sweep's motion (twice its share at 5 Hz, half at 20 Hz), so
        the port departs from them there.  1 / scan_period is
        taken in double and applied as one float32 multiply, so at 0.1
        (1 / 0.1 == 10.0) every s is bit-equal to 10 * frac."""
        inv = 1.0 / scan_period
        return (self.rel - torch.trunc(self.rel)) * inv

    def replace(self, **kw) -> "PointCloud":
        return dataclasses.replace(self, **kw)

    def map(self, fn) -> "PointCloud":
        return _map_fields(self, fn)


@dataclasses.dataclass
class Sweep:
    """Ring-major sweep: xyz (..., n_scans, W, 3), rel/mask (..., n_scans, W)."""

    xyz: torch.Tensor
    rel: torch.Tensor
    mask: torch.Tensor

    def flatten(self) -> PointCloud:
        lead = self.mask.shape[:-2]
        n = self.mask.shape[-2] * self.mask.shape[-1]
        return PointCloud(
            xyz=self.xyz.reshape(lead + (n, 3)),
            rel=self.rel.reshape(lead + (n,)),
            mask=self.mask.reshape(lead + (n,)),
        )


@dataclasses.dataclass
class FeatureClouds:
    """The five published clouds of scanRegistration
    (src/scanRegistration.cpp:584-612)."""

    sharp: PointCloud
    less_sharp: PointCloud
    flat: PointCloud
    less_flat: PointCloud
    full: PointCloud

    def map(self, fn) -> "FeatureClouds":
        """Apply fn to every tensor (e.g. ``lambda t: t[k]`` picks frame k)."""
        return _map_fields(self, lambda c: c.map(fn))


@dataclasses.dataclass
class ImuTrans:
    """The per-sweep "imuTrans" summary the odometry consumes
    (src/scanRegistration.cpp:614-629), each field (..., 3)."""

    rpy_start: torch.Tensor         # pitch, yaw, roll at sweep start
    rpy_cur: torch.Tensor           # pitch, yaw, roll at sweep end
    shift_from_start: torch.Tensor  # nonlinear-motion drift
    velo_from_start: torch.Tensor   # velocity change over the sweep

    @staticmethod
    def zeros(device=None) -> "ImuTrans":
        z = torch.zeros(3, dtype=torch.float32, device=device)
        return ImuTrans(z, z, z, z)

    def map(self, fn) -> "ImuTrans":
        return _map_fields(self, fn)
