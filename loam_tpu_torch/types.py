"""Core tensor containers (counterpart of loam_tpu/types.py).

Fixed-capacity struct-of-arrays with an explicit validity mask.  Any
leading axes (frames, scenarios) ride in front of the point axis.
"""

from __future__ import annotations

import dataclasses

import torch


def _map_fields(obj, fn):
    return dataclasses.replace(
        obj, **{f.name: fn(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    )


@dataclasses.dataclass
class PointCloud:
    """xyz (..., N, 3) float32 internal frame; rel (..., N) the
    ring + scanPeriod*relTime channel; mask (..., N) bool."""

    xyz: torch.Tensor
    rel: torch.Tensor
    mask: torch.Tensor

    @staticmethod
    def zeros(n: int, device=None) -> "PointCloud":
        return PointCloud(
            xyz=torch.zeros((n, 3), dtype=torch.float32, device=device),
            rel=torch.zeros((n,), dtype=torch.float32, device=device),
            mask=torch.zeros((n,), dtype=torch.bool, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return self.mask.sum(-1, dtype=torch.int32)

    def ring(self) -> torch.Tensor:
        """Integer ring id with C truncation (not floor), as int(rel)."""
        return torch.trunc(self.rel).to(torch.int32)

    def sweep_time(self) -> torch.Tensor:
        """s = 10 * (rel - trunc(rel)), src/laserOdometry.cpp:103."""
        return 10.0 * (self.rel - torch.trunc(self.rel))

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
