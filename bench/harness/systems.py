"""What a cell times, behind one interface, so that the control can take
the program's place: ``Port`` is the system under test
(``repro_torch``); ``Control`` is the plain reference computed in the
nearest precision below float32, TF32 (the control that has to come out
as not correct).

A system gives, for weights in the port's layout and a configuration's
``model`` widths:

* ``bulk(params, model)`` → ``fn(batch) -> scores``: one offline pass;
* ``trainer(params, model, hp)`` → an object with ``init(params) -> state``
  and ``step(params, state, batch) -> (params, state, {"loss", "finite"})``.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch

from bench.reference.train import SPARSE_KEY

_PORT_FIELDS = ("name", "interaction", "n_dense", "dense_fc", "predict_fc", "n_tasks",
                "n_tables", "vocab", "embed_dim", "hotness", "pooling", "cin_layers",
                "dnn_widths", "dtype")


@contextlib.contextmanager
def tf32(on: bool):
    """float32 matrix products in TF32 (``on``) or in float32, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _inputs(model: dict, batch: dict) -> dict:
    keys = ("dense", "sparse") if model["interaction"] == "dot" else ("sparse",)
    return {k: batch[k] for k in keys}


class Port:
    """The program: ``repro_torch``'s forward, bulk scoring and training step,
    as its launchers build them."""
    name = "port"

    @staticmethod
    def config(model: dict):
        from repro_torch.models.recsys import RecConfig
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in model.items() if k in _PORT_FIELDS}
        return RecConfig(**kw)

    def bulk(self, params: dict, model: dict):
        from repro_torch.models import recsys
        cfg = self.config(model)
        return lambda batch: recsys.bulk_forward(params, cfg, _inputs(model, batch))

    def trainer(self, params: dict, model: dict, hp: dict):
        """``launch/train.py``'s step: adagrad on the tables, AdamW on the
        towers (``optim.combined``), the global norm clipped."""
        from repro_torch.models import recsys
        from repro_torch.train import loop, optim
        cfg = self.config(model)
        opt = optim.combined(lambda path: SPARSE_KEY in str(path),
                             optim.adagrad(hp["adagrad_lr"]), optim.adamw(hp["adam_lr"]))
        step = loop.make_train_step(lambda p, b: recsys.loss_fn(p, cfg, b), opt,
                                    clip_norm=hp["clip_norm"])
        return _Trainer(opt.init, step)


@dataclasses.dataclass
class _Trainer:
    init: object
    step: object


class Control:
    """The plain reference in the program's place, its products in TF32.

    TF32 is switched on when a driver builds the control's function, which
    it does after importing the port: importing ``repro_torch.device``
    switches it off, the port's own policy."""
    name = "control"

    @staticmethod
    def _tf32() -> None:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True

    def bulk(self, params: dict, model: dict):
        from bench.reference import recsys as ref
        self._tf32()
        return lambda batch: ref.forward(params, model, _inputs(model, batch))

    def trainer(self, params: dict, model: dict, hp: dict):
        from bench.reference.train import Trainer
        self._tf32()
        return Trainer(model, adagrad_lr=hp["adagrad_lr"], adam_lr=hp["adam_lr"],
                       clip_norm=hp["clip_norm"])


def first_grad_norms(state: dict, b1: float = 0.9) -> dict[str, float]:
    """Each leaf's first gradient, as the optimiser got it, read from its
    state after one step: Adagrad's sum of squares is g² (its norm √Σs),
    Adam's first moment is (1-β₁)·g."""
    out = {k: float(torch.sqrt(s.double().sum())) for k, s in state["sparse"].items()}
    for k, m in state["dense"]["mu"].items():
        out[k] = float(torch.linalg.vector_norm(m.double())) / (1 - b1)
    return out
