"""Training: AdamW, the train step and step-sharded checkpoints (port of
``repro.train``)."""
from .optimizer import adamw_init, adamw_update, global_norm  # noqa: F401
from .train_step import loss_fn, make_train_step  # noqa: F401
