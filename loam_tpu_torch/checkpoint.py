"""Checkpoint / resume for pipeline state (counterpart of
loam_tpu/checkpoint.py).

The reference has NO checkpointing: the 4,851-cube map and all poses live
in laserMapping's process memory and die with it (SURVEY.md §5
"Checkpoint / resume"); its only recovery mechanism is roslaunch
respawn with total state loss (launch/loam_velodyne.launch:7).

Here the entire estimator state — odometry clouds/pose, the
device-resident voxel-hash map, IMU-blend bookkeeping — is one dataclass
tree of tensors, so checkpointing is a structural save/restore: the
tensors go to the host and into one ``torch.save`` file (read back with
``weights_only`` loading), the metadata into a JSON file, and the
directory commits atomically by a rename.  Dataset-scale replays
checkpoint every N frames and resume mid-sequence.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import tempfile
from typing import Any

import torch

from .types import tree_map

_STATE = "state.pt"
_META = "meta.json"


def _to_host(obj):
    """A tree of tensors (dataclasses and dicts) as nested dicts of CPU
    tensors."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _to_host(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if obj is None:
        return None
    return obj.detach().to("cpu", copy=True)


def _fill(target, saved, path="state"):
    """target's structure with the saved tensors, each on the device of
    the target tensor it replaces."""
    if dataclasses.is_dataclass(target):
        return dataclasses.replace(target, **{
            f.name: _fill(getattr(target, f.name), saved[f.name],
                          f"{path}.{f.name}")
            for f in dataclasses.fields(target)})
    if isinstance(target, dict):
        return {k: _fill(v, saved[k], f"{path}.{k}")
                for k, v in target.items()}
    if target is None:
        return None
    if saved.shape != target.shape or saved.dtype != target.dtype:
        raise ValueError(f"{path}: checkpoint holds {saved.dtype}"
                         f"{tuple(saved.shape)}, the target "
                         f"{target.dtype}{tuple(target.shape)}")
    return saved.to(target.device)


@dataclasses.dataclass
class CheckpointManager:
    """Save/restore PipelineState (or any tree of tensors: dataclasses
    and dicts) + replay metadata.

    directory layout: <root>/<step>/ per checkpoint ({state.pt,
    meta.json}), written under a temporary name and renamed into place,
    so a <step> directory is always whole.  Saves are synchronous: the
    checkpoint is committed when save returns.
    """

    root: str
    max_to_keep: int = 3

    def __post_init__(self):
        os.makedirs(self.root, exist_ok=True)

    def _dir(self, step: int) -> str:
        return os.path.join(self.root, str(step))

    def steps(self) -> list[int]:
        """The committed checkpoints' steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self.root) if n.isdigit())

    def save(self, step: int, state: Any, *,
             metadata: dict | None = None) -> None:
        """Checkpoint a tree at `step`, then drop all but the newest
        max_to_keep checkpoints."""
        tmp = tempfile.mkdtemp(prefix=f"{step}.tmp", dir=self.root)
        try:
            torch.save(_to_host(state), os.path.join(tmp, _STATE))
            with open(os.path.join(tmp, _META), "w") as f:
                json.dump(metadata or {}, f)
            final = self._dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self._dir(old))

    def restore(self, step: int | None, target: Any) -> tuple[Any, dict]:
        """Restore into the structure of `target` (a concrete tree of the
        same shapes and dtypes), each tensor on the device of the target
        tensor it replaces.  step=None -> latest.
        Returns (state, metadata)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        saved = torch.load(os.path.join(self._dir(step), _STATE),
                           map_location="cpu", weights_only=True)
        with open(os.path.join(self._dir(step), _META)) as f:
            meta = json.load(f)
        return _fill(target, saved), meta

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def close(self) -> None:
        """Nothing is pending (saves are synchronous); kept so that code
        written for loam_tpu's manager runs unchanged."""


def _n_frames(inputs) -> int:
    sizes = []
    tree_map(lambda t: sizes.append(t.shape[0]), inputs)
    return sizes[0]


def checkpointed_replay(step_fn, state, inputs, ckpt: CheckpointManager,
                        every: int = 50, start_frame: int = 0):
    """Frame-loop replay with periodic checkpointing and resume.

    step_fn(state, per_frame_input) -> (state, out); inputs is a
    dataclass tree (or tuple) of tensors with a leading frame axis.
    Resumes from ckpt's latest step when start_frame == 0 and
    checkpoints exist.

    Returns (final_state, list_of_outputs_from_processed_frames).
    """
    n_frames = _n_frames(inputs)
    first = start_frame
    if first == 0:
        latest = ckpt.latest_step()
        if latest is not None:
            state, meta = ckpt.restore(latest, state)
            first = int(meta.get("next_frame", latest))
    outs = []
    for k in range(first, n_frames):
        frame = tree_map(lambda x: x[k], inputs)
        state, out = step_fn(state, frame)
        outs.append(out)
        if every and (k + 1) % every == 0:
            ckpt.save(k + 1, state, metadata={"next_frame": k + 1})
    return state, outs
