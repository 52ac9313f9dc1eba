"""The models: the ten architecture families of ``configs/`` in plain
PyTorch (the reference's ``models/`` calls no kernel either), their
serving steps and their train step."""
from .config import ModelConfig
from .steps import (cross_entropy, init_train_state, loss_and_grads,
                    make_prefill_step, make_serve_step, make_train_step,
                    pad_cache)
from .transformer import Model, params_from_reference

__all__ = ["ModelConfig", "Model", "params_from_reference",
           "make_prefill_step", "make_serve_step", "pad_cache",
           "cross_entropy", "init_train_state", "loss_and_grads",
           "make_train_step"]
