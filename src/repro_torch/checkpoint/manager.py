"""Checkpointing with atomic manifests + async flush: the reference's
``checkpoint/manager.py`` on PyTorch.

A checkpoint is the reference's layout: ``step_XXXXXXXX/arrays.npz`` and
``manifest.json``, written to ``step_XXXXXXXX.tmp`` and renamed into
place (a crash mid-write never corrupts the latest checkpoint), the last
``keep`` kept, the file write on a thread while training goes on.  Keys
are the reference's flattened pytree paths (``params/blocks/attn/wq``,
``opt_state/m/embed/table``, ``opt_state/count``, ``step``), with the
port's per-layer tensors stacked into the reference's ``[L, ...]`` leaves
(``[units, m_per, ...]`` for xlstm's mLSTM blocks): a dotted name's
numeric parts (``blocks.3.attn.wq``) index the stack.  So either
package's float32 checkpoint restores in the other's.  numpy has no
bfloat16: the port writes a bfloat16 leaf as float32 (exact) and the
manifest keeps its dtype; restore casts each leaf back to the dtype of
the tensor it replaces and copies it into that tensor, in place and on
its device.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

#: (key parts, stack index, tensor) of one leaf of a state.
_Entry = Tuple[Tuple[str, ...], Tuple[int, ...], torch.Tensor]


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _entries(node: Any, path: Tuple[str, ...]) -> Iterator[_Entry]:
    """Every tensor leaf of a state, in the reference's flattening order
    of its containers, with its dotted names split into parts."""
    if isinstance(node, torch.Tensor):
        yield _split(path) + (node,)
    elif isinstance(node, nn.Module):
        for name, p in node.named_parameters():
            yield from _entries(p, path + tuple(name.split(".")))
    elif _is_namedtuple(node):
        for f in node._fields:
            yield from _entries(getattr(node, f), path + (f,))
    elif isinstance(node, dict):
        for k in sorted(node):
            yield from _entries(node[k], path + tuple(str(k).split(".")))
    elif isinstance(node, (tuple, list)):
        for i, c in enumerate(node):
            yield from _entries(c, path + (f"[{i}]",))
    elif node is not None:
        raise TypeError(f"checkpoint: no tensor leaf at "
                        f"{'/'.join(path)}: {type(node).__name__}")


def _split(path: Tuple[str, ...]) -> Tuple[str, Tuple[int, ...]]:
    """("blocks", "3", "attn", "wq") -> ("blocks/attn/wq", (3,))."""
    key = "/".join(p for p in path if not p.isdigit())
    return key, tuple(int(p) for p in path if p.isdigit())


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf on the host; bfloat16, which numpy lacks, cast to float32
    there, so that a save allocates nothing on the leaf's device."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _flatten(state: Any) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    """Host arrays by reference key, per-layer leaves stacked, and each
    key's dtype name."""
    groups: Dict[str, List[Tuple[Tuple[int, ...], torch.Tensor]]] = {}
    for key, idx, t in _entries(state, ()):
        groups.setdefault(key, []).append((idx, t))
    host, dtypes = {}, {}
    for key, items in groups.items():
        dtypes[key] = str(items[0][1].dtype).replace("torch.", "")
        if len(items) == 1 and not items[0][0]:
            host[key] = _to_numpy(items[0][1])
            continue
        shape = tuple(max(ix[d] for ix, _ in items) + 1
                      for d in range(len(items[0][0])))
        if len(items) != int(np.prod(shape)):
            raise ValueError(f"checkpoint: {key}'s layers do not fill a "
                             f"{shape} stack")
        first = _to_numpy(items[0][1])
        arr = np.empty(shape + first.shape, first.dtype)
        for ix, t in items:
            arr[ix] = _to_numpy(t)
        host[key] = arr
    return host, dtypes


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        # a bfloat16 leaf written where numpy knew the type (ml_dtypes)
        arr = arr.view(np.int16)
        return torch.from_numpy(np.asarray(arr)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(arr))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_write: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self._pending: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, state: Any, blocking: bool = False) -> str:
        """Gather to host synchronously, write asynchronously."""
        host, dtypes = _flatten(state)
        meta = {"step": int(step),
                "keys": {k: [list(v.shape), dtypes[k]]
                         for k, v in host.items()},
                "time": time.time()}
        self.wait()
        if self.async_write and not blocking:
            self._pending = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._pending.start()
        else:
            self._write(step, host, meta)
        return self._step_dir(step)

    def _write(self, step: int, host: Dict[str, np.ndarray], meta: Dict):
        tmp = self._step_dir(step) + ".tmp"
        final = self._step_dir(step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace("/", "__"): v for k, v in host.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)               # atomic publish
        self._gc()

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    # -- restore ------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = list(self.latest_steps())
        return max(steps) if steps else None

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Restore into ``state_like``: every tensor leaf takes the saved
        value, cast to its dtype, copied in place on its device.  Returns
        ``state_like``."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._step_dir(step)
        groups: Dict[str, List[Tuple[Tuple[int, ...], torch.Tensor]]] = {}
        for key, idx, leaf in _entries(state_like, ()):
            groups.setdefault(key, []).append((idx, leaf))
        with np.load(os.path.join(path, "arrays.npz")) as data, \
                torch.no_grad():
            for key, items in groups.items():
                name = key.replace("/", "__")
                if name not in data.files:
                    raise KeyError(f"checkpoint {path} missing {key}")
                arr = data[name]            # read once, sliced per layer
                for idx, leaf in items:
                    val = _from_numpy(arr[idx] if idx else arr)
                    if tuple(val.shape) != tuple(leaf.shape):
                        raise ValueError(
                            f"checkpoint {path}: {key}{list(idx)} has shape "
                            f"{tuple(val.shape)}, the state "
                            f"{tuple(leaf.shape)}")
                    leaf.copy_(val)         # casts on the way
        return state_like

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def _gc(self):
        steps = sorted(self.latest_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def latest_steps(self):
        for d in os.listdir(self.directory):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    yield int(d.split("_")[1])
                except ValueError:
                    pass
