"""Checkpoint / resume for solver state and AMG hierarchies.

The reference persists matrices/vectors through its BlaIO writers and
keeps direct-solver factorizations alive across solves via the staged
MUMPS/PARDISO job API (XtrMumps.c fasp_solver_mumps_steps).  The device
equivalent (SURVEY.md §5): serialize the frozen hierarchy pytree (all
device arrays + static treedef) so an expensive setup is paid once and
reused across processes, plus plain solver-iterate snapshots.

Format: a single .npz with the flattened leaves + a pickled treedef.

SECURITY: checkpoints are TRUSTED input only.  The treedef blob is
unpickled on load (np.load itself runs with allow_pickle=False, but the
treedef round-trip needs pickle because pytree node types are arbitrary
registered classes) — loading a checkpoint from an untrusted source can
execute arbitrary code, exactly like torch.load.  Never feed user-uploaded
files to load_pytree.
"""
from __future__ import annotations

import json
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _encode_aux(treedef) -> str:
    # treedef reprs are stable within a version; store for validation only
    return repr(treedef)


def save_pytree(path: str, tree: Any, meta: dict = None) -> None:
    """Save any pytree of arrays (e.g. an AMGHierarchy) to one .npz."""
    import pickle

    leaves, treedef = jax.tree_util.tree_flatten(tree)
    arrays = {f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        pickle.dumps(treedef), dtype=np.uint8)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_pytree(path: str, device: bool = True) -> Tuple[Any, dict]:
    """Load a pytree saved by :func:`save_pytree`; returns (tree, meta).

    TRUSTED INPUT ONLY — unpickles the treedef (see module docstring)."""
    import pickle

    with np.load(path, allow_pickle=False) as z:
        treedef = pickle.loads(z["__treedef__"].tobytes())
        meta = json.loads(z["__meta__"].tobytes().decode())
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    if device:
        leaves = [jnp.asarray(l) for l in leaves]
    return jax.tree_util.tree_unflatten(treedef, leaves), meta


def save_hierarchy(path: str, hier, extra_meta: dict = None) -> None:
    """Persist an AMG hierarchy (setup is the expensive phase; reference
    re-runs it per matrix — here it can be checkpointed)."""
    meta = dict(kind="amg_hierarchy",
                levels=[int(l.A.shape[0]) for l in hier.levels])
    meta.update(extra_meta or {})
    save_pytree(path, hier, meta)


def load_hierarchy(path: str):
    tree, meta = load_pytree(path)
    if meta.get("kind") != "amg_hierarchy":
        raise ValueError(f"{path} is not an AMG hierarchy checkpoint")
    return tree


def save_iterate(path: str, x, iteration: int, relres: float) -> None:
    """Solver-iterate snapshot for long runs (resume support)."""
    np.savez_compressed(path, x=np.asarray(x),
                        iteration=np.int64(iteration),
                        relres=np.float64(relres))


def load_iterate(path: str):
    with np.load(path) as z:
        return z["x"], int(z["iteration"]), float(z["relres"])
