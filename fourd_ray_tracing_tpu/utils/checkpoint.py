"""Checkpoint / resume for accumulation buffers and optimizer state.

The reference has none (SURVEY §5): its progressive accumulation lives
in a GL texture and dies on exit. Here, long accumulation runs and
inverse-rendering optimizations save/restore the flattened pytree
leaves as one ``leaves.npz`` (single-file checkpoints are sufficient
per SURVEY §5), with a versioned sidecar that turns the two real
failure modes into actionable errors:

* **Structure drift** — restoring into a differently-shaped pytree
  (scene edited between save and resume, optimizer swapped) would
  silently misassign leaves; the sidecar records a structure
  fingerprint and `restore` diffs it first.
* **Format drift** — a checkpoint written by an older layout raises a
  versioned error instead of silently misreading.

`save_train_state` / `restore_train_state` checkpoint the PACKED
production training loop (diff.make_packed_train_step): the flat scene
vector, the optimizer state and the step counter in one artifact.
"""
from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any

import jax
import numpy as np

# 3: leaves in leaves.npz (versions <= 2 were orbax directories).
FORMAT_VERSION = 3
_META = "fourd_ckpt_meta.json"
_LEAVES = "leaves.npz"


def _fingerprint(state: Any) -> str:
    """Stable structure fingerprint: treedef plus per-leaf shape/dtype."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    desc = repr(treedef) + "".join(
        f"|{np.shape(l)}:{np.asarray(l).dtype}" for l in leaves
    )
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


def save(path: str | Path, state: Any) -> None:
    """Save a pytree (accumulation image, frame counter, optimizer
    state...) plus the versioned structure sidecar."""
    path = Path(path).absolute()
    path.mkdir(parents=True, exist_ok=True)
    leaves = jax.tree_util.tree_leaves(state)
    np.savez(path / _LEAVES,
             **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)})
    (path / _META).write_text(json.dumps({
        "format_version": FORMAT_VERSION,
        "structure": _fingerprint(state),
        "n_leaves": len(jax.tree_util.tree_leaves(state)),
    }))


def restore(path: str | Path, like: Any) -> Any:
    """Restore a pytree saved by `save`; ``like`` supplies
    structure/shapes. Raises ValueError with a structural diff hint when
    ``like`` does not match what was saved."""
    path = Path(path).absolute()
    meta_path = path / _META
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
        if meta.get("format_version", 1) > FORMAT_VERSION:
            raise ValueError(
                f"checkpoint at {path} has format_version "
                f"{meta['format_version']}, newer than this build's "
                f"{FORMAT_VERSION} — upgrade the package to restore it"
            )
        if meta.get("format_version", 1) < FORMAT_VERSION:
            raise ValueError(
                f"checkpoint at {path} has format_version "
                f"{meta.get('format_version', 1)} (an orbax directory); "
                f"this build reads format {FORMAT_VERSION} only"
            )
        want = _fingerprint(like)
        if meta.get("structure") not in (None, want):
            n_like = len(jax.tree_util.tree_leaves(like))
            raise ValueError(
                f"checkpoint structure mismatch at {path}: saved "
                f"fingerprint {meta['structure']} ({meta.get('n_leaves')} "
                f"leaves) != restore target {want} ({n_like} leaves). "
                "The scene/optimizer shape changed since the save — "
                "rebuild the matching pytree (same scene structure, same "
                "optimizer) or start fresh."
            )
    like_leaves, treedef = jax.tree_util.tree_flatten(like)
    with np.load(path / _LEAVES) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(like_leaves))]
    return jax.tree_util.tree_unflatten(treedef, leaves)


def save_train_state(path: str | Path, scene_vec, opt_state, step: int) -> None:
    """Checkpoint the packed production training loop
    (diff.make_packed_train_step): flat scene vector + optimizer state +
    step counter in one artifact."""
    save(path, {
        "scene_vec": scene_vec,
        "opt_state": opt_state,
        "step": np.int64(step),
    })


def restore_train_state(path: str | Path, like_vec, like_opt_state):
    """-> (scene_vec, opt_state, step). ``like_*`` come from
    make_packed_train_step's init on the template scene."""
    out = restore(path, {
        "scene_vec": like_vec,
        "opt_state": like_opt_state,
        "step": np.int64(0),
    })
    return out["scene_vec"], out["opt_state"], int(out["step"])
