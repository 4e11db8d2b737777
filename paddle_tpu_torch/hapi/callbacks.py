"""hapi callbacks (counterpart of ``paddle_tpu/hapi/callbacks.py``,
Paddle's ``paddle.callbacks``): ``Callback``, ``CallbackList``,
``ProgBarLogger``, ``ModelCheckpoint``, ``EarlyStopping``,
``LRScheduler`` and ``VisualDL``, which writes one JSON line a logged
step to ``<log_dir>/scalars.jsonl``."""
from __future__ import annotations

import json
import os
import time

import numpy as np

__all__ = ["Callback", "ProgBarLogger", "ModelCheckpoint", "EarlyStopping", "VisualDL",
           "LRScheduler", "CallbackList"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_model(self, model):
        self.model = model

    def set_params(self, params):
        self.params = params or {}

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


class CallbackList:
    def __init__(self, callbacks=None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kwargs):
                for cb in self.callbacks:
                    getattr(cb, name)(*args, **kwargs)
            return dispatch
        raise AttributeError(name)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._epoch_t0 = time.time()

    def on_train_batch_end(self, step, logs=None):
        if self.verbose and step % self.log_freq == 0:
            logs = logs or {}
            items = ", ".join(
                f"{k}: {self._fmt(v)}" for k, v in logs.items())
            total = f"/{self.steps}" if self.steps else ""
            print(f"Epoch {self.epoch + 1}/{self.epochs} "
                  f"step {step}{total} - {items}", flush=True)

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._epoch_t0
            logs = logs or {}
            items = ", ".join(
                f"{k}: {self._fmt(v)}" for k, v in logs.items())
            print(f"Epoch {epoch + 1} done ({dt:.1f}s) - {items}",
                  flush=True)

    def on_eval_end(self, logs=None):
        if self.verbose:
            logs = logs or {}
            items = ", ".join(
                f"{k}: {self._fmt(v)}" for k, v in logs.items())
            print(f"Eval - {items}", flush=True)

    @staticmethod
    def _fmt(v):
        if isinstance(v, (list, tuple, np.ndarray)):
            return "[" + ", ".join(f"{float(x):.4f}" for x in
                                   np.ravel(v)) + "]"
        try:
            return f"{float(v):.4f}"
        except (TypeError, ValueError):
            return str(v)


class ModelCheckpoint(Callback):
    def __init__(self, save_freq=1, save_dir=None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.monitor_op = np.greater
            self.min_delta *= 1
        else:
            self.monitor_op = np.less
            self.min_delta *= -1
        self.best = None
        self.wait = 0
        self.stopped_epoch = 0

    def on_eval_end(self, logs=None):
        logs = logs or {}
        current = logs.get(self.monitor)
        if current is None:
            return
        if isinstance(current, (list, tuple, np.ndarray)):
            current = float(np.ravel(current)[0])
        if self.best is None or self.monitor_op(
                current - self.min_delta, self.best):
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        lr = getattr(opt, "_learning_rate", None) if opt else None
        from ..optimizer.lr import LRScheduler as Sched
        return lr if isinstance(lr, Sched) else None

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s is not None:
                s.step()

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s is not None:
                s.step()


class VisualDL(Callback):
    """``paddle.callbacks.VisualDL``'s constructor and metric contract:
    each training batch's and each evaluation's logs go to
    ``<log_dir>/scalars.jsonl``, one record ``{"mode", "step", <name>:
    float}`` a line. (The reference also writes TensorBoard event files
    where ``torch.utils.tensorboard`` imports; the port writes the JSON
    lines only.)"""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._jsonl = None
        self._step = {"train": 0, "eval": 0}

    def _log(self, mode, logs):
        if self._jsonl is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._jsonl = open(os.path.join(self.log_dir, "scalars.jsonl"),
                               "a")
        record = {"mode": mode, "step": self._step[mode]}
        for k, v in (logs or {}).items():
            try:
                record[k] = float(np.asarray(v).reshape(-1)[0])
            except (TypeError, ValueError):
                continue
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        self._step[mode] += 1

    def on_train_batch_end(self, step, logs=None):
        self._log("train", logs)

    def on_eval_end(self, logs=None):
        self._log("eval", logs)

    def on_train_end(self, logs=None):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
