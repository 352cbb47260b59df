"""Callback event bus: the 19 named hooks of yolov3_tpu/utils/callbacks.py
(the reference's extension surface, reference utils/callbacks.py:7-61)."""

from __future__ import annotations

import threading


class Callbacks:
    """Named-hook registry; loggers and user code attach actions to hooks."""

    HOOKS = (
        "on_pretrain_routine_start",
        "on_pretrain_routine_end",
        "on_train_start",
        "on_train_epoch_start",
        "on_train_batch_start",
        "optimizer_step",
        "on_before_zero_grad",
        "on_train_batch_end",
        "on_train_epoch_end",
        "on_val_start",
        "on_val_batch_start",
        "on_val_image_end",
        "on_val_batch_end",
        "on_val_end",
        "on_fit_epoch_end",
        "on_model_save",
        "on_train_end",
        "on_params_update",
        "teardown",
    )

    def __init__(self):
        self._callbacks = {h: [] for h in self.HOOKS}
        self.stop_training = False

    def register_action(self, hook, name="", callback=None):
        assert hook in self._callbacks, f"hook '{hook}' not in {self.HOOKS}"
        assert callable(callback), f"callback '{callback}' is not callable"
        self._callbacks[hook].append({"name": name, "callback": callback})

    def get_registered_actions(self, hook=None):
        return self._callbacks[hook] if hook else self._callbacks

    def run(self, hook, *args, thread=False, **kwargs):
        assert hook in self._callbacks, f"hook '{hook}' not in {self.HOOKS}"
        for logger in self._callbacks[hook]:
            if thread:
                threading.Thread(target=logger["callback"], args=args, kwargs=kwargs, daemon=True).start()
            else:
                logger["callback"](*args, **kwargs)
