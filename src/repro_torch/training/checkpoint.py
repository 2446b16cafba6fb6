"""Checkpointing: atomic, keep-N, restore onto any device (counterpart of
``repro.training.checkpoint``), in the JAX package's own format, so a
checkpoint crosses between the two packages both ways.

Format: one ``.npz`` per checkpoint of flattened leaves: ``p``, ``m`` and
``v`` (params and the AdamW moments) followed by each leaf's path as
``jax.tree_util.keystr`` writes it (``p['layers']['attn']['wq']``), bf16
leaves stored as their uint16 bit pattern under a ``~bf16~`` prefix (npz
has no bf16), and the scalars ``__step`` and ``__opt_step``.  It is
written to a temp file and renamed into place, so a crash mid-write never
corrupts the newest checkpoint.  ``save_async`` snapshots to the host and
writes on a daemon thread (joined before the next save).

Restore returns host tensors; ``device_put_tree`` places them on any
device, or on a sharded pod's members.
"""

from __future__ import annotations

import os
import re
import tempfile
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.distributed.sharding import TPGroup, shard_put
from repro_torch.training.optimizer import AdamWState
from repro_torch.training.tree import paths, rebuild, tree_map

_SAVE_THREAD: Optional[threading.Thread] = None
BF16 = "~bf16~"


def _flatten(tree: Any, prefix: str) -> dict[str, np.ndarray]:
    out = {}
    for path, leaf in paths(tree):
        key = prefix + path
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # npz can't store bf16: uint16 bits
            out[BF16 + key] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[key] = t.numpy()
    return out


def _unflatten(template: Any, arrays: dict[str, np.ndarray], prefix: str
               ) -> Any:
    flat = []
    for path, _ in paths(template):
        key = prefix + path
        if key in arrays:
            flat.append(torch.from_numpy(np.array(arrays[key])))
        else:
            bits = np.array(arrays[BF16 + key]).view(np.int16)
            flat.append(torch.from_numpy(bits).view(torch.bfloat16))
    return rebuild(template, flat)


def save(ckpt_dir: str, step: int, params: Any,
         opt_state: Optional[AdamWState] = None, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = _flatten(params, "p")
    if opt_state is not None:
        payload.update(_flatten(opt_state.m, "m"))
        payload.update(_flatten(opt_state.v, "v"))
        payload["__opt_step"] = np.asarray(int(opt_state.step), np.int32)
    payload["__step"] = np.asarray(step)
    final = os.path.join(ckpt_dir, f"ckpt_{step:08d}.npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, final)  # atomic
    _gc(ckpt_dir, keep)
    return final


def _to_host(tree: Any) -> Any:
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def save_async(ckpt_dir: str, step: int, params: Any,
               opt_state: Optional[AdamWState] = None, keep: int = 3
               ) -> threading.Thread:
    """Snapshot to the host, then write on a background thread."""
    global _SAVE_THREAD
    if _SAVE_THREAD is not None:
        _SAVE_THREAD.join()
    params_host = _to_host(params)
    opt_host = None if opt_state is None else AdamWState(
        step=opt_state.step.clone(), m=_to_host(opt_state.m),
        v=_to_host(opt_state.v))
    _SAVE_THREAD = threading.Thread(
        target=save, args=(ckpt_dir, step, params_host, opt_host, keep),
        daemon=True)
    _SAVE_THREAD.start()
    return _SAVE_THREAD


def wait_for_async_save() -> None:
    if _SAVE_THREAD is not None:
        _SAVE_THREAD.join()


def list_checkpoints(ckpt_dir: str) -> list[tuple[int, str]]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"ckpt_(\d+)\.npz", name)
        if m:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return sorted(out)


def _gc(ckpt_dir: str, keep: int) -> None:
    for _, path in list_checkpoints(ckpt_dir)[:-keep]:
        os.remove(path)


def restore(path: str, params_template: Any,
            opt_template: Optional[AdamWState] = None
            ) -> tuple[int, Any, Optional[AdamWState]]:
    """(step, params, opt_state) of the checkpoint at ``path``, host
    tensors in the templates' nesting (opt_state None without an
    ``opt_template`` or without moments in the file)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    step = int(arrays["__step"])
    params = _unflatten(params_template, arrays, "p")
    opt_state = None
    if opt_template is not None and "__opt_step" in arrays:
        opt_state = AdamWState(
            step=torch.as_tensor(arrays["__opt_step"], dtype=torch.int32),
            m=_unflatten(opt_template.m, arrays, "m"),
            v=_unflatten(opt_template.v, arrays, "v"))
    return step, params, opt_state


def restore_latest(ckpt_dir: str, params_template: Any = None,
                   opt_template: Optional[AdamWState] = None):
    """(step, params, opt_state) of the newest checkpoint, or None.
    Without a template the arrays come back as a flat dict of numpy
    arrays under their keys (the caller reshapes)."""
    ckpts = list_checkpoints(ckpt_dir)
    if not ckpts:
        return None
    _, path = ckpts[-1]
    if params_template is None:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
        return int(arrays["__step"]), arrays, None
    return restore(path, params_template, opt_template)


def device_put_tree(tree: Any, target, names: Any = None) -> Any:
    """Elastic restore (``device_put_sharded_tree``'s counterpart): a host
    tree onto ``target``, a device, or a sharded pod's ``TPGroup``, whose
    members each take their slice of every leaf (``shard_put`` by
    ``names``, ``Model.param_names()``): then a list of member trees,
    primary first."""
    if isinstance(target, TPGroup):
        if names is None:
            raise ValueError("device_put_tree: a TPGroup needs the leaves' "
                             "logical names (Model.param_names())")
        return shard_put(tree, names, target)
    return tree_map(lambda t: t.to(target), tree)
