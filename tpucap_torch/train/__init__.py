"""Training of the port: teacher-forced masked cross-entropy on the merge
LSTM decoder (``loop.make_train_step``) and joint encoder + decoder
fine-tuning (``finetune.make_joint_train_step``), single device, with
tpucap's optimizers and lr schedules (``loop.build_optimizer``), gradient
accumulation, the SIGTERM guard of preemptible runs
(``preemption.PreemptionGuard``) and LoRA (``lora``).
Port of the matching parts of ``tpucap.train``."""

from tpucap_torch.train.finetune import (
    encode_for_decoder,
    encoder_learning_rate_optimizer,
    make_joint_train_step,
)
from tpucap_torch.train.loop import (
    TrainState,
    build_optimizer,
    make_eval_step,
    make_eval_sums_step,
    make_train_step,
    own_state,
)
from tpucap_torch.train.loss import (
    caption_loss_sums,
    cast_floats,
    loss_from_sums,
    masked_cross_entropy_sums,
)
from tpucap_torch.train.preemption import PreemptionGuard
from tpucap_torch.train.sequences import (
    batch_iterator,
    build_training_batch,
    build_training_tokens,
)

__all__ = [
    "PreemptionGuard",
    "TrainState",
    "batch_iterator",
    "build_optimizer",
    "build_training_batch",
    "build_training_tokens",
    "caption_loss_sums",
    "cast_floats",
    "encode_for_decoder",
    "encoder_learning_rate_optimizer",
    "loss_from_sums",
    "make_eval_step",
    "make_eval_sums_step",
    "make_joint_train_step",
    "make_train_step",
    "masked_cross_entropy_sums",
    "own_state",
]
