"""Training, the counterpart of ``sdtpu/train``: the LDM train step
(``step``), LoRA adapters for training and serving (``lora``) and the
streaming data input (``data``). The exports are the reference's, with
``make_train_step`` in place of ``jit_train_step`` (PyTorch runs eagerly:
a callable with the knobs fixed, updating the state in place)."""

from sdtpu_torch.train.step import (  # noqa: F401
    TrainState,
    init_train_state,
    ldm_loss,
    load_train_state,
    make_optimizer,
    make_train_step,
    save_train_state,
    train_step,
)
