"""A restricted unpickler for reference checkpoints that ``weights_only``
refuses (the port's own counterpart of ``emojivoice_tpu.io.torch_pickle``).

The reference's released voices are Lightning checkpoints whose
``hyper_parameters`` are pickled omegaconf objects (hydra composes them);
``torch.load(weights_only=True)`` refuses those.  This module is a pickle
module for ``torch.load(..., weights_only=False, pickle_module=torch_pickle)``
whose ``Unpickler`` resolves only an allow-list: the tensor rebuild
(``torch._utils._rebuild_tensor_v2``, ``_rebuild_parameter``),
``collections.OrderedDict``, ``torch.Size`` and the dtypes (storages are
resolved by ``torch.load`` itself).  Every other global becomes an inert
stand-in class that only records what the stream hands it (constructor
arguments, ``__setstate__`` state, dict and list items), so no code of the
checkpoint runs: a ``__reduce__`` that names ``os.system`` gets a stand-in
for it, called with its arguments, which does nothing.

``plain_hparams`` walks the stand-ins of omegaconf's state layout back into
plain python (``DictConfig``/``ListConfig`` keep their children under
``_content``, ``ValueNode`` leaves under ``_val``, ``"???"`` is MISSING;
Lightning's ``AttributeDict`` is a dict subclass whose items are collected).
"""

from __future__ import annotations

import collections
import pickle
from typing import Any

import torch
import torch._utils

# (module, name) → the object it resolves to; everything else gets a stand-in
_ALLOWED = {
    ("torch._utils", "_rebuild_tensor_v2"): torch._utils._rebuild_tensor_v2,
    ("torch._utils", "_rebuild_parameter"): torch._utils._rebuild_parameter,
    ("collections", "OrderedDict"): collections.OrderedDict,
    ("torch", "Size"): torch.Size,
}


class StandIn:
    """What a class outside the allow-list becomes: it keeps the data the
    pickle stream carries and runs nothing."""

    def __init__(self, *args, **kwargs):
        self.args = args

    def __call__(self, *args, **kwargs):
        return self

    def __setstate__(self, state):
        self.state = state

    # NEWOBJ skips __init__, so the item stores are made lazily
    def __setitem__(self, k, v):  # dict-subclass pickles: obj[k] = v
        self.__dict__.setdefault("dict_items", {})[k] = v

    def append(self, v):  # list-subclass pickles: obj.append(v)
        self.__dict__.setdefault("list_items", []).append(v)

    def extend(self, vs):
        self.__dict__.setdefault("list_items", []).extend(vs)


class Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) in _ALLOWED:
            return _ALLOWED[(module, name)]
        if module == "torch" and isinstance(getattr(torch, name, None), torch.dtype):
            return getattr(torch, name)
        return type(name, (StandIn,), {"__module__": module})


def load(file, **kwargs) -> Any:
    """``pickle.load`` through the restricted ``Unpickler``."""
    return Unpickler(file, **kwargs).load()


def plain_hparams(obj: Any) -> Any:
    """The stand-ins of omegaconf / Lightning objects as plain python."""
    if isinstance(obj, dict):
        return {k: plain_hparams(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain_hparams(v) for v in obj]
    st = getattr(obj, "state", None)
    if isinstance(st, dict):
        if "_content" in st:
            return plain_hparams(st["_content"])
        if "_val" in st:
            v = st["_val"]
            return None if (isinstance(v, str) and v == "???") else plain_hparams(v)
        return {k: plain_hparams(v) for k, v in st.items() if not str(k).startswith("_")}
    items = getattr(obj, "dict_items", None)
    if isinstance(items, dict):
        return {k: plain_hparams(v) for k, v in items.items()}
    items = getattr(obj, "list_items", None)
    if isinstance(items, list):
        return [plain_hparams(v) for v in items]
    return obj
