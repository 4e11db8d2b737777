"""``paddle.Model`` (counterpart of ``paddle_tpu/hapi/model.py``): the
high-level train / evaluate / predict loop over a network.

The model runs on its network's device. Batches (numpy arrays or
tensors, as the ``DataLoader`` gives them) move there each step.
``train_batch`` goes through the port's :class:`~paddle_tpu_torch.jit.
TrainStep` when ``prepare(jit_compile=True)`` (the default), as the
reference's goes through its compiled step, and through the eager
``loss.backward()``; ``optimizer.step()`` otherwise; either way it reads
the loss back once, for the logs. As in the reference, metrics are not
computed in ``train_batch`` (the step's only output is its loss): they
accumulate in ``eval_batch`` / ``evaluate``. ``predict_batch`` returns
numpy arrays (bfloat16 outputs as float32).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..metric import Metric
from .callbacks import CallbackList, ModelCheckpoint, ProgBarLogger

__all__ = ["Model", "summary_impl"]


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._train_step = None
        self._jit_train = True
        self.stop_training = False

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None, jit_compile=True):
        self._optimizer = optimizer
        self._loss = loss
        if metrics is not None:
            self._metrics = _as_list(metrics)
        self._jit_train = jit_compile
        return self

    @property
    def device(self):
        return next(self.network.parameters()).device

    def _on_device(self, xs):
        dev = self.device
        return [torch.as_tensor(np.asarray(x)).to(dev)
                if not isinstance(x, torch.Tensor) else x.to(dev)
                for x in _as_list(xs)]

    def _loss_value(self, outputs, labels):
        if self._loss is None:
            raise ValueError("call prepare(loss=...) before training")
        loss = self._loss(*_as_list(outputs), *_as_list(labels))
        if isinstance(loss, (list, tuple)):
            return sum(loss[1:], loss[0])
        return loss

    def train_batch(self, inputs, labels=None, update=True):
        """One step on ``inputs`` / ``labels``; returns ``[loss]`` (a
        float)."""
        self.network.train()
        inputs, labels = self._on_device(inputs), self._on_device(labels)
        if self._jit_train and update:
            if self._train_step is None:
                from ..jit import TrainStep

                def loss_fn(out, args, kwargs):
                    return self._loss_value(out, list(kwargs["_labels"]))
                self._train_step = TrainStep(self.network, loss_fn,
                                             self._optimizer)
            return [float(self._train_step(*inputs, _labels=tuple(labels)))]
        loss = self._loss_value(self.network(*inputs), labels)
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        return [float(loss.detach())]

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        """The loss (when a loss and labels are given) as ``[float]``;
        each metric takes the batch."""
        self.network.eval()
        inputs, labels = self._on_device(inputs), self._on_device(labels)
        outputs = self.network(*inputs)
        out = []
        if self._loss is not None and labels:
            out.append(float(self._loss_value(outputs, labels)))
        for m in self._metrics:
            res = m.compute(*_as_list(outputs), *labels)
            m.update(*(res if isinstance(res, (list, tuple)) else [res]))
        return out

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        out = self.network(*self._on_device(inputs))
        return [(o.float() if o.dtype == torch.bfloat16 else o).cpu()
                .numpy() for o in _as_list(out)]

    def _loader(self, data, batch_size, num_workers, **kw):
        from ..io import DataLoader, Dataset
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size,
                              num_workers=num_workers, **kw)
        return data

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, accumulate_grad_batches=1, num_iters=None):
        train_loader = self._loader(train_data, batch_size, num_workers,
                                    shuffle=shuffle, drop_last=drop_last)
        eval_loader = self._loader(eval_data, batch_size, num_workers) \
            if eval_data is not None else None
        cbks = CallbackList([ProgBarLogger(log_freq, verbose)]
                            + (callbacks or []))
        if save_dir:
            cbks.append(ModelCheckpoint(save_freq, save_dir))
        cbks.set_model(self)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbks.set_params({"epochs": epochs, "steps": steps,
                         "verbose": verbose})
        self.stop_training = False
        cbks.on_train_begin()
        global_step, logs = 0, {}
        for epoch in range(epochs):
            cbks.on_epoch_begin(epoch)
            logs = {}
            for step, batch in enumerate(train_loader):
                cbks.on_train_batch_begin(step)
                inputs, labels = self._split_batch(batch)
                logs = {"loss": self.train_batch(inputs, labels)}
                cbks.on_train_batch_end(step, logs)
                global_step += 1
                if num_iters is not None and global_step >= num_iters:
                    break
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                cbks.on_eval_end(self.evaluate(eval_loader, verbose=0))
            if self.stop_training:
                break
        cbks.on_train_end(logs)

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        """``{"loss": [mean batch loss], <metric name>: value}``."""
        loader = self._loader(eval_data, batch_size, num_workers)
        for m in self._metrics:
            m.reset()
        losses = []
        for batch in loader:
            out = self.eval_batch(*self._split_batch(batch))
            if out:
                losses.append(out[0])
        logs = {"loss": [float(np.mean(losses))]} if losses else {}
        for m in self._metrics:
            names = m.name() if callable(getattr(m, "name", None)) \
                else [str(m)]
            logs.update(zip(_as_list(names), _as_list(m.accumulate())))
        if verbose:
            print(" - ".join(f"{k}: {v}" for k, v in logs.items()))
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        """A list (one entry a batch) of lists of output arrays; with
        ``stack_outputs``, one array an output over every batch."""
        outputs = [self.predict_batch(self._split_batch(b)[0])
                   for b in self._loader(test_data, batch_size,
                                         num_workers)]
        if stack_outputs and outputs:
            return [np.concatenate([o[i] for o in outputs])
                    for i in range(len(outputs[0]))]
        return outputs

    @staticmethod
    def _split_batch(batch):
        if isinstance(batch, (list, tuple)):
            if len(batch) == 2:
                return batch[0], batch[1]
            return batch[:-1], batch[-1]
        return batch, None

    def save(self, path, training=True):
        """``path.pdparams`` (the network's state) and, with ``training``,
        ``path.pdopt`` (the optimizer's)."""
        from ..framework.io import save
        save(self.network.state_dict(), path + ".pdparams")
        if training and self._optimizer is not None:
            save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework.io import load
        self.network.set_state_dict(load(path + ".pdparams"))
        opt_path = path + ".pdopt"
        if not reset_optimizer and self._optimizer is not None \
                and os.path.exists(opt_path):
            self._optimizer.set_state_dict(load(opt_path))

    def parameters(self, *args, **kwargs):
        return self.network.parameters(*args, **kwargs)

    def summary(self, input_size=None, dtype=None):
        return summary_impl(self.network, input_size, dtype)


def summary_impl(network, input_size=None, dtype=None):
    """Print each parameter's name, shape and size; return the total and
    trainable counts."""
    total, trainable, lines = 0, 0, []
    for name, p in network.named_parameters():
        n = p.numel()
        total += n
        trainable += n if p.requires_grad else 0
        lines.append(f"  {name:60s} {str(list(p.shape)):24s} {n}")
    print("\n".join(lines))
    print(f"Total params: {total:,}")
    print(f"Trainable params: {trainable:,}")
    return {"total_params": total, "trainable_params": trainable}
