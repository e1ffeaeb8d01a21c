"""Checkpoint / resume of the filter state (counterpart of the JAX package's
utils/checkpoint.py): the flat npz of a whole state, and the sharded
checkpoint of a state split over a device mesh.

The npz (save_state / load_state) holds the StepState's leaves,
`leaf_{i}`, in the order the JAX package's tree flattening gives them:
StepState's fields in order, each NamedTuple field's own fields in order,
a None atlas contributing no leaves. A checkpoint written by either
package therefore resumes in the other. A mesh-sharded sweep state goes
through it after parallel/sweep.gather_states.

The sharded checkpoint (save_state_sharded / load_state_sharded, the JAX
package's orbax pair) is a torch.distributed.checkpoint directory of the
same leaves as DTensors: every rank's block is a DTensor view over the
mesh, placed as shard_dims says (Shard on the axes that
split the leaf, Replicate on the others). Every rank writes its own blocks
(a replicated block once), and a load reads each rank's block of the
target placement, so a resume on the same mesh is bit-equal and a resume
on another mesh works by passing a state sharded on that mesh as `like`.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from gcslam_torch.models.atlas import TABLE_FIELDS, AtlasState
from gcslam_torch.models.scan_step import StepState
from gcslam_torch.utils.tree import tree_leaves, tree_rebuild


def state_leaves(state: StepState) -> List[torch.Tensor]:
    """The state's tensors in the checkpoint's (the JAX tree-flatten) order."""
    return tree_leaves(state)


def state_from_leaves(like: StepState, leaves) -> StepState:
    """A StepState of the structure of `like` with the given tensors, in
    state_leaves order."""
    return tree_rebuild(like, leaves)


def shard_dims(states: StepState) -> List[Dict[str, int]]:
    """For each leaf of a batched state (state_leaves order), the dim that
    each mesh axis splits: "run" dim 0 of every leaf, "hyp" dim 1 of the
    beliefs and hyp_weights, "map" dim 1 of the atlas payload."""
    dims = []
    for name, sub in zip(StepState._fields, states):
        if sub is None:
            continue
        if name == "atlas":
            dims += [{"run": 0} if f in TABLE_FIELDS else {"run": 0, "map": 1} for f in AtlasState._fields]
        else:
            d = {"run": 0, "hyp": 1} if name in ("beliefs", "hyp_weights") else {"run": 0}
            dims += [d] * (len(sub) if isinstance(sub, tuple) else 1)
    return dims


def save_state(path: str, state: StepState) -> None:
    """Write every leaf of `state` to the npz at `path`."""
    arrs = {f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(state_leaves(state))}
    np.savez_compressed(path, **arrs)


def load_state(path: str, like: StepState) -> StepState:
    """Restore into the structure, dtypes and device of `like` (an
    initialized StepState of the same config); a leaf of another shape
    raises (config mismatch)."""
    restored = []
    with np.load(path) as data:
        for i, ref in enumerate(state_leaves(like)):
            arr = data[f"leaf_{i}"]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint leaf {i} shape {arr.shape} != expected {tuple(ref.shape)} "
                                 "(config mismatch)")
            restored.append(torch.as_tensor(arr).to(device=ref.device, dtype=ref.dtype))
    return state_from_leaves(like, restored)


def _dtensor_dict(state: StepState, mesh) -> dict:
    """{leaf_i: DTensor view of this rank's block of leaf i over the mesh}."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    out = {}
    for i, (x, dims) in enumerate(zip(state_leaves(state), shard_dims(state))):
        placements = [Shard(dims[axis]) if axis in dims else Replicate() for axis in mesh.axis_names]
        out[f"leaf_{i}"] = DTensor.from_local(x, mesh.device_mesh, placements, run_check=False)
    return out


def save_state_sharded(path: str, state: StepState, mesh) -> None:
    """Write this rank's blocks of a mesh-sharded state to the checkpoint
    directory `path` (every rank of the mesh calls it)."""
    import torch.distributed.checkpoint as dcp

    dcp.save(_dtensor_dict(state, mesh), checkpoint_id=path)


def load_state_sharded(path: str, like: StepState, mesh) -> StepState:
    """Restore into the structure, dtypes and placement of `like`, this
    rank's block of a state sharded on `mesh` (every rank of the mesh calls
    it). `like` is left as it was."""
    import torch.distributed.checkpoint as dcp

    target = _dtensor_dict(state_from_leaves(like, [x.clone() for x in state_leaves(like)]), mesh)
    dcp.load(target, checkpoint_id=path)
    return state_from_leaves(like, [target[f"leaf_{i}"].to_local() for i in range(len(target))])
